"""Multiscale PCA denoising (Bakshi 1998; paper Sec. 2.1) in PyTorch.

The twin of ``repro.signal.mspca``. A data matrix of N samples x P
variables (the paper's 2048 x 180: 60 windows x 3 channels) is DWT'd
along the samples, PCA-reconstructed per scale, and inverse-DWT'd. The
port works variable-major throughout: the (P, N) layout is the windows
tensor itself, reshaped, and is what the DWT and ``pca.fit_T`` take.
All functions accept leading batch axes (the chunks of an engine step).

``reference_kernels=True`` runs the reference's pre-megabatch math: the
DWT level by level in the gather form, each scale transposed to
sample-major and fitted there (``pca.fit``) with the full-width masked
reconstruction, and the longhand transpose synthesis.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import pca
from repro_torch.signal import wavelet


def _pca_reconstruct(
    mat: torch.Tensor, keep: int | str, reference: bool = False
) -> torch.Tensor:
    """Sample-major twin of ``_pca_reconstruct_T``: PCA across the P
    columns of mat (..., N, P). An int ``keep`` slices the components;
    ``reference=True`` takes the full-width masked form instead."""
    st = pca.fit(mat)
    if keep == "kaiser":
        k = pca.kaiser_rule(st).clamp(max=mat.shape[-1])
        return pca.reconstruct(st, mat, k)
    return pca.reconstruct(st, mat, int(keep), masked=reference)


def _pca_reconstruct_T(
    cT: torch.Tensor, keep: int | str, reference: bool = False
) -> torch.Tensor:
    """PCA across the P variables of cT (..., P, n); keep ``keep``
    components ("kaiser": eigenvalue above the mean) and reconstruct.
    ``reference=True`` takes the reference's pre-megabatch shape instead:
    transposed to sample-major, ``_pca_reconstruct`` with the masked
    reconstruction, transposed back."""
    if reference:
        return _pca_reconstruct(cT.transpose(-1, -2), keep, reference=True).transpose(-1, -2)
    st = pca.fit_T(cT)
    if keep == "kaiser":
        k = pca.kaiser_rule(st).clamp(max=cT.shape[-2])
        return pca.reconstruct_T(st, cT, k)
    return pca.reconstruct_T(st, cT, int(keep))


def _hard_threshold(d: torch.Tensor, sigma: torch.Tensor, n: int) -> torch.Tensor:
    """Universal threshold sigma * sqrt(2 log n) over ``n`` samples; d may
    be sample- or variable-major, sigma (...,) one per leading index."""
    thr = sigma * math.sqrt(2.0 * math.log(n))
    return torch.where(d.abs() > thr[..., None, None], d, 0.0)


def _denoise_T(
    xT: torch.Tensor, *, level: int, wavelet_name: str, threshold: bool,
    keep: int | str, final_pca: bool, reference_kernels: bool = False,
) -> torch.Tensor:
    xT = xT.to(torch.float32)
    mean = xT.mean(dim=-1, keepdim=True)
    coeffs = wavelet.dwt(xT - mean, level, wavelet_name, reference=reference_kernels)
    if threshold:
        # Universal threshold from the finest-scale median absolute
        # deviation. quantile(.., 0.5) averages the two middle values as
        # jnp.median does (torch.median would return the lower one).
        sigma = torch.quantile(coeffs[0].abs().flatten(-2), 0.5, dim=-1) / 0.6745
    new_coeffs = []
    for j, c in enumerate(coeffs):  # c (..., P, n_j)
        rec = _pca_reconstruct_T(c, keep, reference=reference_kernels)
        if threshold and j < len(coeffs) - 1:  # details only, not A_L
            rec = _hard_threshold(rec, sigma, n=c.shape[-1])
        new_coeffs.append(rec)
    xd = wavelet.idwt(new_coeffs, wavelet_name, reference=reference_kernels)
    if final_pca:  # Bakshi step 4
        xd = _pca_reconstruct_T(xd, keep, reference=reference_kernels)
    return xd + mean


def denoise(
    x: torch.Tensor,
    level: int = 5,
    wavelet_name: str = "db4",
    threshold: bool = False,
    keep: int | str = 30,
    final_pca: bool = False,
    reference_kernels: bool = False,
) -> torch.Tensor:
    """MSPCA-denoise X (..., N, P) -> (..., N, P). The defaults are the
    reference's classification-stable variant (fixed keep, no hard
    threshold, no final full-scale pass)."""
    den = _denoise_T(
        x.transpose(-1, -2), level=level, wavelet_name=wavelet_name,
        threshold=threshold, keep=keep, final_pca=final_pca,
        reference_kernels=reference_kernels,
    )
    return den.transpose(-1, -2)


def denoise_windows(
    windows: torch.Tensor,
    level: int = 5,
    wavelet_name: str = "db4",
    halo: torch.Tensor | None = None,
    reference_kernels: bool = False,
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
        final_pca=False, reference_kernels=reference_kernels,
    )
    return den.reshape(lead + (h + w, c, n))[..., h:, :, :]


def denoise_stream_chunked(
    stream: torch.Tensor,
    overlap: int,
    per: int = 60,
    level: int = 5,
    wavelet_name: str = "db4",
) -> torch.Tensor:
    """Chunked denoise of a chunk-aligned (K*per, C, N) stream, one
    ``denoise_windows`` call per chunk, each taking the previous chunk's
    last ``overlap`` RAW windows as its halo (zeros before the first
    chunk): the longhand form of what ``frontend.frontend_step`` computes
    per step, and the seam harness ``worst_seam_snr_db`` reads."""
    k, rem = divmod(stream.shape[0], per)
    if rem:
        raise ValueError(f"stream of {stream.shape[0]} windows is not {per}-aligned")
    chunks = stream.reshape((k, per) + tuple(stream.shape[1:]))
    halo = (
        torch.zeros((overlap,) + tuple(stream.shape[1:]), dtype=torch.float32,
                    device=stream.device)
        if overlap else None
    )
    outs = []
    for c in chunks:
        outs.append(denoise_windows(c, level=level, wavelet_name=wavelet_name, halo=halo))
        if overlap:
            halo = c[per - overlap:].to(torch.float32)
    return torch.cat(outs)


def worst_seam_snr_db(
    reference: torch.Tensor,
    denoised: torch.Tensor,
    per: int = 60,
    seam_windows: int = 8,
) -> float:
    """Worst per-seam ``snr_db`` of chunked ``denoised`` output against the
    ``reference`` (the stream denoised as ONE matrix), each seam scored
    over the ``seam_windows`` windows after a chunk boundary. Higher is
    better; the first chunk has no seam and is left out."""
    n_chunks = reference.shape[0] // per
    return min(
        float(snr_db(reference[k * per : k * per + seam_windows],
                     denoised[k * per : k * per + seam_windows]))
        for k in range(1, n_chunks)
    )


def snr_db(clean: torch.Tensor, noisy: torch.Tensor) -> torch.Tensor:
    """SNR of ``noisy`` against ``clean`` in dB; both powers floored at
    1e-12 so a zero-power input gives a finite value."""
    err = noisy - clean
    return 10.0 * torch.log10(
        (clean**2).sum().clamp(min=1e-12) / (err**2).sum().clamp(min=1e-12)
    )
