"""Periodized DWT and wavelet packet decomposition (paper Sec. 2.2) in PyTorch.

The twin of ``repro.signal.wavelet``. One analysis level passes x through
the low-pass h and high-pass g filters and keeps every second sample;
the operator a[n] = sum_k h[k] x[(2n + k) mod N] has orthonormal rows, so
synthesis is its transpose and round trips are exact. Every analysis
level -- the WPD features and MSPCA's DWT alike -- goes through
``kernels.wpd`` (K2 on a CUDA tensor: one launch for a whole packet tree
or DWT). Synthesis is plain PyTorch in the
reference's pad + static-slice polyphase form.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.wpd import ops as wpd_ops

# Daubechies scaling (low-pass) filters, sum = sqrt(2).
_DAUBECHIES: dict[str, list[float]] = {
    "db1": [0.7071067811865476, 0.7071067811865476],
    "db2": [
        0.48296291314469025, 0.836516303737469,
        0.22414386804185735, -0.12940952255092145,
    ],
    "db3": [
        0.3326705529509569, 0.8068915093133388, 0.4598775021193313,
        -0.13501102001039084, -0.08544127388224149, 0.035226291882100656,
    ],
    "db4": [
        0.23037781330885523, 0.7148465705525415, 0.6308807679295904,
        -0.02798376941698385, -0.18703481171888114, 0.030841381835986965,
        0.032883011666982945, -0.010597401784997278,
    ],
}


@functools.cache
def filters(name: str = "db4") -> tuple[torch.Tensor, torch.Tensor]:
    """(low-pass h, high-pass g) float32 CPU tensors, g[k] = (-1)^k h[L-1-k].
    Shared and cached: callers must not write into them."""
    if name not in _DAUBECHIES:
        raise ValueError(f"unknown wavelet {name!r}; have {sorted(_DAUBECHIES)}")
    h = torch.tensor(_DAUBECHIES[name], dtype=torch.float32)
    n_taps = h.shape[0]
    g = torch.tensor(
        [(-1.0) ** k * float(h[n_taps - 1 - k]) for k in range(n_taps)],
        dtype=torch.float32,
    )
    return h, g


def analysis_step(
    x: torch.Tensor, wavelet: str = "db4"
) -> tuple[torch.Tensor, torch.Tensor]:
    """One level: x (..., N) -> (approx (..., N/2), detail (..., N/2))."""
    return wpd_ops.wpd_level(x, *filters(wavelet))


def synthesis_step(
    a: torch.Tensor, d: torch.Tensor, wavelet: str = "db4"
) -> torch.Tensor:
    """Inverse of ``analysis_step``: output sample 2m+p collects taps
    k = 2j+p from coefficient (m - j) mod half. Each branch is circularly
    padded once at the front, every tap is a static slice, and the even
    and odd phases are interleaved at the end."""
    h, g = (f.tolist() for f in filters(wavelet))
    half = a.shape[-1]
    taps = len(h) // 2
    if half < taps - 1:
        return synthesis_step_reference(a, d, wavelet)
    if taps > 1:
        pa = torch.cat([a[..., half - (taps - 1):], a], dim=-1)
        pd = torch.cat([d[..., half - (taps - 1):], d], dim=-1)
    else:
        pa, pd = a, d
    even = torch.zeros_like(a)
    odd = torch.zeros_like(a)
    for j in range(taps):
        sa = pa[..., taps - 1 - j : taps - 1 - j + half]
        sd = pd[..., taps - 1 - j : taps - 1 - j + half]
        even = even + h[2 * j] * sa + g[2 * j] * sd
        odd = odd + h[2 * j + 1] * sa + g[2 * j + 1] * sd
    return torch.stack([even, odd], dim=-1).reshape(a.shape[:-1] + (2 * half,))


def synthesis_step_reference(
    a: torch.Tensor, d: torch.Tensor, wavelet: str = "db4"
) -> torch.Tensor:
    """The longhand transpose: scatter-add each coefficient's taps (the
    oracle ``synthesis_step`` is tested against)."""
    h, g = (f.to(a.device) for f in filters(wavelet))
    n = 2 * a.shape[-1]
    idx = (
        2 * torch.arange(n // 2, device=a.device)[:, None]
        + torch.arange(h.shape[0], device=a.device)[None, :]
    ) % n  # (N/2, L)
    contrib = a[..., :, None] * h + d[..., :, None] * g  # (..., N/2, L)
    out = torch.zeros(a.shape[:-1] + (n,), dtype=a.dtype, device=a.device)
    return out.index_add_(-1, idx.reshape(-1), contrib.flatten(-2))


def dwt(x: torch.Tensor, level: int, wavelet: str = "db4") -> list[torch.Tensor]:
    """Multi-level DWT of the last axis: [D1, D2, ..., D_level, A_level],
    each scale its own contiguous tensor (one K2 launch on a CUDA tensor)."""
    return wpd_ops.dwt_levels(x, *filters(wavelet), level)


def idwt(coeffs: list[torch.Tensor], wavelet: str = "db4") -> torch.Tensor:
    """Inverse of ``dwt``."""
    cur = coeffs[-1]
    for d in reversed(coeffs[:-1]):
        cur = synthesis_step(cur, d, wavelet)
    return cur


def wpd(x: torch.Tensor, level: int, wavelet: str = "db4") -> torch.Tensor:
    """Wavelet packet decomposition: x (..., N) -> (..., 2**level,
    N // 2**level) terminal nodes in natural (Paley) order; every level
    splits every node (node 2i is the low branch of node i, 2i+1 the high
    one). One K2 launch on a CUDA tensor."""
    return wpd_ops.wpd_tree(x, *filters(wavelet), level)
