"""Streaming signal front-end: the scoring path's map phase, in PyTorch.

The twin of ``repro.signal.frontend``. ``FrontendState`` carries each
stream's context (the last ``max(1, overlap)`` RAW windows and the chunk
phase); ``frontend_step`` consumes one chunk per stream, and
``megabatch_step`` consumes a (B, D) backlog in one batched heavy pass,
taking each chunk's halo from its predecessor in the backlog itself.
Batch axes are written out where the reference used ``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.signal import eeg_data, features, mspca
from repro_torch.signal.pipeline import check_supported


class FrontendState(NamedTuple):
    """boundary (..., H, C, N) float32: the last H = max(1, overlap) raw
    windows of the stream (zeros before the first chunk); phase (...,)
    int32: chunks consumed so far."""

    boundary: torch.Tensor
    phase: torch.Tensor


def boundary_width(overlap: int) -> int:
    """Carried boundary windows for an overlap setting (always >= 1)."""
    return max(1, overlap)


def init_batch(
    batch: int,
    n_channels: int = eeg_data.N_CHANNELS,
    window: int = eeg_data.WINDOW,
    overlap: int = 0,
    *,
    device: torch.device | str,
) -> FrontendState:
    """(B,)-leading zero states: one per engine slot."""
    return FrontendState(
        boundary=torch.zeros(
            (batch, boundary_width(overlap), n_channels, window),
            dtype=torch.float32, device=device,
        ),
        phase=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _wrap_pad(chunk: torch.Tensor, total: int) -> torch.Tensor:
    """Cyclically tile the window axis (-3) to ``total`` windows, as
    ``jnp.resize`` does (torch's ``resize_`` does not tile)."""
    w = chunk.shape[-3]
    reps = -(-total // w)
    return torch.cat([chunk] * reps, dim=-3)[..., :total, :, :]


def chunk_features(
    chunk_windows: torch.Tensor, cfg, halo: torch.Tensor | None = None
) -> torch.Tensor:
    """(..., W, C, N) chunks -> (..., W, F) feature rows: denoise each
    chunk's 8-minute matrices, then WPD-featurize every window.

    A chunk of W != 60 windows is wrap-padded by cyclic tiling to whole
    60-window matrices (the reference's train/serve-consistent layout).
    With ``cfg.overlap = h > 0``, ``halo`` (..., h, C, N) holds the raw
    windows preceding each chunk (``None``: a stream start, zeros); it
    joins the FIRST matrix, and each later matrix of a padded chunk takes
    the raw tail of its predecessor in padded order.
    """
    check_supported(cfg)
    if cfg.denoise:
        w, c, n = chunk_windows.shape[-3:]
        lead = chunk_windows.shape[:-3]
        per = eeg_data.WINDOWS_PER_MATRIX
        h = cfg.overlap
        if h > per:
            raise ValueError(
                f"overlap={h} exceeds WINDOWS_PER_MATRIX={per}: the halo "
                "must come from the immediately preceding denoise matrix"
            )
        n_mat = max(1, -(-w // per))
        padded = _wrap_pad(chunk_windows, n_mat * per) if n_mat * per != w else chunk_windows
        mats = padded.reshape(lead + (n_mat, per, c, n))
        halos = None
        if h:
            if halo is None:
                halo = torch.zeros(lead + (h, c, n), dtype=torch.float32,
                                   device=chunk_windows.device)
            if tuple(halo.shape) != tuple(lead) + (h, c, n):
                raise ValueError(
                    f"halo shape {tuple(halo.shape)} != {tuple(lead) + (h, c, n)} "
                    f"for overlap={h}"
                )
            halos = torch.cat(
                [halo.to(torch.float32).unsqueeze(-4), mats[..., :-1, per - h:, :, :]],
                dim=-4,
            )
        den = mspca.denoise_windows(
            mats, level=cfg.mspca_level, wavelet_name=cfg.wavelet, halo=halos
        )
        chunk_windows = den.reshape(lead + (n_mat * per, c, n))[..., :w, :, :]
    return features.wpd_features(
        chunk_windows, level=cfg.wpd_level, wavelet_name=cfg.wavelet
    )


def frontend_step(
    state: FrontendState, chunk_windows: torch.Tensor, cfg
) -> tuple[FrontendState, torch.Tensor]:
    """Consume one (..., W, C, N) chunk per stream: returns the advanced
    state (last raw windows, phase + 1) and the (..., W, F) features.
    With ``cfg.overlap`` the carried boundary is the denoise halo."""
    feats = chunk_features(
        chunk_windows, cfg, halo=state.boundary if cfg.overlap else None
    )
    bw = state.boundary.shape[-3]
    boundary = torch.cat(
        [state.boundary, chunk_windows.to(torch.float32)], dim=-3
    )[..., -bw:, :, :]
    return FrontendState(boundary=boundary, phase=state.phase + 1), feats


def megabatch_step(
    state: FrontendState, chunks: torch.Tensor, active: torch.Tensor, cfg
) -> tuple[FrontendState, torch.Tensor]:
    """D backlog chunks per stream in one batched pass.

    state  : (B,)-leading ``FrontendState``.
    chunks : (B, D, W, C, N) raw backlog, slot-major.
    active : (B, D) PREFIX masks (real chunks first, then padding).
    Returns the state after each stream's ``take = sum(active[b])``
    chunks and (B, D, W, F) features; rows of padding chunks are
    computed from stale halos and must be masked by the caller.
    """
    b, d, w, c, n = chunks.shape
    bw = state.boundary.shape[1]
    # Per-stream raw window sequence: boundary, then the backlog; chunk
    # d's halo is windows [d*w, d*w + bw) of it.
    stream = torch.cat(
        [state.boundary, chunks.to(torch.float32).reshape(b, d * w, c, n)], dim=1
    )
    arange_bw = torch.arange(bw, device=chunks.device)
    halos = None
    if cfg.overlap:
        halo_idx = torch.arange(d, device=chunks.device)[:, None] * w + arange_bw
        halos = stream[:, halo_idx]  # (B, D, bw, C, N)
    feats = chunk_features(chunks, cfg, halo=halos)
    take = active.to(torch.int32).sum(dim=1)
    # Last bw raw windows of (boundary ++ chunks[:take]); take == 0 keeps
    # the old boundary.
    rows = torch.arange(b, device=chunks.device)[:, None]
    new_boundary = stream[rows, take[:, None].long() * w + arange_bw]
    return FrontendState(boundary=new_boundary, phase=state.phase + take), feats
