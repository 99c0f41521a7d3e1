"""Periodized DWT and wavelet packet decomposition (paper Sec. 2.2) in PyTorch.

The twin of ``repro.signal.wavelet``. One analysis level passes x through
the low-pass h and high-pass g filters and keeps every second sample;
the operator a[n] = sum_k h[k] x[(2n + k) mod N] has orthonormal rows, so
synthesis is its transpose and round trips are exact. Every analysis
level -- the WPD features and MSPCA's DWT alike -- goes through
``kernels.wpd`` (K2 on a CUDA tensor: one launch for a whole packet tree
or DWT). Synthesis is plain PyTorch in the
reference's pad + static-slice polyphase form.

``reference=True`` keeps the reference's pre-megabatch formulations, which
the ``PipelineConfig(reference_kernels=True)`` leg runs: analysis level by
level as a gather + matmul (on a CUDA tensor, K2's single-level launch,
the TPU kernel's own contract, which tiles that gather layout) and
synthesis as the longhand transpose, summed in the scatter-add's order.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels._route import on_cuda
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


def _window_indices(n: int, taps: int, device=None) -> torch.Tensor:
    """(n//2, taps) gather indices: row i reads x[(2i + k) mod n]."""
    base = 2 * torch.arange(n // 2, device=device)[:, None]
    return (base + torch.arange(taps, device=device)[None, :]) % n


def analysis_step(
    x: torch.Tensor, wavelet: str = "db4", *, reference: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """One level: x (..., N) -> (approx (..., N/2), detail (..., N/2)).
    ``reference=True`` on a CPU tensor is the gather + matmul form: the
    (..., N/2, L) window matrix times each filter."""
    h, g = filters(wavelet)
    if not reference or on_cuda(x, "analysis_step"):
        return wpd_ops.wpd_level(x, h, g)
    n = x.shape[-1]
    if n % 2:
        raise ValueError(f"signal length {n} must be even")
    xw = x.to(torch.float32)[..., _window_indices(n, h.shape[0], x.device)]
    return xw @ h, xw @ g


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


@functools.cache
def _transpose_order(n: int, taps: int, device: torch.device) -> torch.Tensor:
    """(n, taps // 2) positions in the flattened (n/2, taps) window table:
    row o lists the (coefficient, tap) pairs that land on output sample o,
    in the table's flat order. Every output of the periodized transpose
    gets exactly taps // 2 of them (the taps of its parity)."""
    idx = _window_indices(n, taps).reshape(-1)
    order = torch.argsort(idx, stable=True)
    return order.reshape(n, taps // 2).to(device)


def synthesis_step_reference(
    a: torch.Tensor, d: torch.Tensor, wavelet: str = "db4"
) -> torch.Tensor:
    """The longhand transpose: each output sample sums its coefficients'
    taps (the oracle ``synthesis_step`` is tested against). The taps are
    gathered into a row per output and added from a zero, left to right in
    the window table's flat order: the order in which a scatter-add
    (``index_add_``) visits them on the CPU, so the bits are the scatter
    form's, and the same on every call on any device (no atomics)."""
    h, g = (f.to(a.device) for f in filters(wavelet))
    n = 2 * a.shape[-1]
    contrib = (a[..., :, None] * h + d[..., :, None] * g).flatten(-2)  # (..., N/2 * L)
    rows = contrib[..., _transpose_order(n, h.shape[0], a.device)]     # (..., N, L/2)
    out = torch.zeros(a.shape[:-1] + (n,), dtype=a.dtype, device=a.device)
    for j in range(rows.shape[-1]):
        out = out + rows[..., j]
    return out


def dwt(
    x: torch.Tensor, level: int, wavelet: str = "db4", *, reference: bool = False
) -> list[torch.Tensor]:
    """Multi-level DWT of the last axis: [D1, D2, ..., D_level, A_level],
    each scale its own contiguous tensor (one K2 launch on a CUDA tensor).
    ``reference=True`` goes level by level through the reference
    ``analysis_step`` (one K2 launch a level on a CUDA tensor)."""
    if not reference:
        return wpd_ops.dwt_levels(x, *filters(wavelet), level)
    coeffs = []
    cur = x
    for _ in range(level):
        cur, d = analysis_step(cur, wavelet, reference=True)
        coeffs.append(d)
    coeffs.append(cur)
    return coeffs


def idwt(
    coeffs: list[torch.Tensor], wavelet: str = "db4", *, reference: bool = False
) -> torch.Tensor:
    """Inverse of ``dwt``; ``reference=True`` synthesizes each level by the
    longhand transpose ``synthesis_step_reference``."""
    step = synthesis_step_reference if reference else synthesis_step
    cur = coeffs[-1]
    for d in reversed(coeffs[:-1]):
        cur = step(cur, d, wavelet)
    return cur


def wpd(
    x: torch.Tensor, level: int, wavelet: str = "db4", *, reference: bool = False
) -> torch.Tensor:
    """Wavelet packet decomposition: x (..., N) -> (..., 2**level,
    N // 2**level) terminal nodes in natural (Paley) order; every level
    splits every node (node 2i is the low branch of node i, 2i+1 the high
    one). One K2 launch on a CUDA tensor; ``reference=True`` goes level by
    level through the reference ``analysis_step``."""
    if not reference:
        return wpd_ops.wpd_tree(x, *filters(wavelet), level)
    lead, n = x.shape[:-1], x.shape[-1]
    if n % (2**level) != 0:
        raise ValueError(f"signal length {n} not divisible by 2**{level}")
    nodes = x.unsqueeze(-2)
    for _ in range(level):
        a, d = analysis_step(nodes, wavelet, reference=True)
        nodes = torch.stack([a, d], dim=-2).reshape(lead + (a.shape[-2] * 2, a.shape[-1]))
    return nodes


def wpd_reconstruct(nodes: torch.Tensor, wavelet: str = "db4") -> torch.Tensor:
    """Inverse WPD: (..., 2**level, M) -> (..., 2**level * M)."""
    while nodes.shape[-2] > 1:
        pairs = nodes.reshape(nodes.shape[:-2] + (nodes.shape[-2] // 2, 2, nodes.shape[-1]))
        nodes = synthesis_step(pairs[..., 0, :], pairs[..., 1, :], wavelet)
    return nodes[..., 0, :]
