"""Multiscale PCA denoising (Bakshi 1998; paper Sec. 2.1) in PyTorch.

The twin of ``repro.signal.mspca``. A data matrix of N samples x P
variables (the paper's 2048 x 180: 60 windows x 3 channels) is DWT'd
along the samples, PCA-reconstructed per scale, and inverse-DWT'd. The
port works variable-major throughout: the (P, N) layout is the windows
tensor itself, reshaped, and is what the DWT and ``pca.fit_T`` take.
All functions accept leading batch axes (the chunks of an engine step).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import pca
from repro_torch.signal import wavelet


def _pca_reconstruct_T(cT: torch.Tensor, keep: int | str) -> torch.Tensor:
    """PCA across the P variables of cT (..., P, n); keep ``keep``
    components ("kaiser": eigenvalue above the mean) and reconstruct."""
    st = pca.fit_T(cT)
    if keep == "kaiser":
        k = pca.kaiser_rule(st).clamp(max=cT.shape[-2])
        return pca.reconstruct_T(st, cT, k)
    return pca.reconstruct_T(st, cT, int(keep))


def _denoise_T(
    xT: torch.Tensor, *, level: int, wavelet_name: str, threshold: bool,
    keep: int | str, final_pca: bool,
) -> torch.Tensor:
    xT = xT.to(torch.float32)
    mean = xT.mean(dim=-1, keepdim=True)
    coeffs = wavelet.dwt(xT - mean, level, wavelet_name)  # [(..., P, n_j)]
    if threshold:
        # Universal threshold from the finest-scale median absolute
        # deviation. quantile(.., 0.5) averages the two middle values as
        # jnp.median does (torch.median would return the lower one).
        sigma = torch.quantile(coeffs[0].abs().flatten(-2), 0.5, dim=-1) / 0.6745
    new_coeffs = []
    for j, c in enumerate(coeffs):
        rec = _pca_reconstruct_T(c, keep)
        if threshold and j < len(coeffs) - 1:  # details only, not A_L
            thr = sigma * math.sqrt(2.0 * math.log(c.shape[-1]))
            rec = torch.where(rec.abs() > thr[..., None, None], rec, 0.0)
        new_coeffs.append(rec)
    xd = wavelet.idwt(new_coeffs, wavelet_name)
    if final_pca:  # Bakshi step 4
        xd = _pca_reconstruct_T(xd, keep)
    return xd + mean


def denoise(
    x: torch.Tensor,
    level: int = 5,
    wavelet_name: str = "db4",
    threshold: bool = False,
    keep: int | str = 30,
    final_pca: bool = False,
) -> torch.Tensor:
    """MSPCA-denoise X (..., N, P) -> (..., N, P). The defaults are the
    reference's classification-stable variant (fixed keep, no hard
    threshold, no final full-scale pass)."""
    den = _denoise_T(
        x.transpose(-1, -2), level=level, wavelet_name=wavelet_name,
        threshold=threshold, keep=keep, final_pca=final_pca,
    )
    return den.transpose(-1, -2)


def denoise_windows(
    windows: torch.Tensor,
    level: int = 5,
    wavelet_name: str = "db4",
    halo: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., W, C, N) raw windows -> (..., W, C, N) denoised: one 8-minute
    matrix per leading index, whose W*C channel-windows are the variables.

    ``halo``: optional (..., H, C, N) raw windows that precede the chunk
    in the stream; they join the matrix as H*C extra variables (so the
    per-scale PCA bases see across the seam) and are dropped after.
    """
    w, c, n = windows.shape[-3:]
    lead = windows.shape[:-3]
    h = 0 if halo is None else halo.shape[-3]
    if h:
        windows = torch.cat([halo.to(windows.dtype), windows], dim=-3)
    xT = windows.reshape(lead + ((h + w) * c, n))
    den = _denoise_T(
        xT, level=level, wavelet_name=wavelet_name, threshold=False, keep=30,
        final_pca=False,
    )
    return den.reshape(lead + (h + w, c, n))[..., h:, :, :]


def snr_db(clean: torch.Tensor, noisy: torch.Tensor) -> torch.Tensor:
    """SNR of ``noisy`` against ``clean`` in dB; both powers floored at
    1e-12 so a zero-power input gives a finite value."""
    err = noisy - clean
    return 10.0 * torch.log10(
        (clean**2).sum().clamp(min=1e-12) / (err**2).sum().clamp(min=1e-12)
    )
