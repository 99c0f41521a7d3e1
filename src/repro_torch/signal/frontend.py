"""Streaming signal front-end: the scoring path's map phase, in PyTorch.

The twin of ``repro.signal.frontend``. ``FrontendState`` carries each
stream's context (the last ``max(1, overlap)`` RAW windows and the chunk
phase); ``frontend_step`` consumes one chunk per stream, ``scan_stream``
a stream of chunks one after the other, and ``megabatch_step`` a (B, D)
backlog in one batched heavy pass, taking each chunk's halo from its
predecessor in the backlog itself. ``state_to_arrays`` /
``state_from_arrays`` carry a state through ``checkpoint.store`` in the
reference's layout, and ``StreamingFrontend`` featurizes a stream fed in
pieces of any size, resumable from its ``state_dict``.
Batch axes are written out where the reference used ``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.signal import eeg_data, features, mspca


class FrontendState(NamedTuple):
    """boundary (..., H, C, N) float32: the last H = max(1, overlap) raw
    windows of the stream (zeros before the first chunk); phase (...,)
    int32: chunks consumed so far."""

    boundary: torch.Tensor
    phase: torch.Tensor


def boundary_width(overlap: int) -> int:
    """Carried boundary windows for an overlap setting (always >= 1)."""
    return max(1, overlap)


def init_state(
    n_channels: int = eeg_data.N_CHANNELS,
    window: int = eeg_data.WINDOW,
    overlap: int = 0,
    *,
    device: torch.device | str,
) -> FrontendState:
    """Zero context: a stream that has not produced a chunk yet."""
    return FrontendState(
        boundary=torch.zeros(
            (boundary_width(overlap), n_channels, window),
            dtype=torch.float32, device=device,
        ),
        phase=torch.zeros((), dtype=torch.int32, device=device),
    )


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


def state_to_arrays(state: FrontendState) -> dict[str, np.ndarray]:
    """One stream's (or a (B,)-leading batch's) context as a flat numpy
    dict in the reference's layout: {"boundary": float32, "phase": int32}.
    The arrays are copies: serializing never aliases the live state."""
    return {
        "boundary": state.boundary.detach().cpu().numpy().astype(np.float32, copy=True),
        "phase": state.phase.detach().cpu().numpy().astype(np.int32, copy=True),
    }


def state_from_arrays(
    arrays: dict, *, width: int | None = None, device: torch.device | str
) -> FrontendState:
    """Inverse of ``state_to_arrays`` (numpy arrays or tensors, either
    package's), on ``device``. Raises ``ValueError`` for a layout that is
    neither a single stream ((H, C, N) + ()) nor a batch ((B, H, C, N) +
    (B,)), and for a boundary depth other than ``width`` (a state saved
    under another ``overlap``)."""
    boundary = np.asarray(arrays["boundary"], np.float32)
    phase = np.asarray(arrays["phase"], np.int32)
    if boundary.ndim not in (3, 4) or phase.ndim != boundary.ndim - 3:
        raise ValueError(
            f"frontend state layout mismatch: boundary ndim "
            f"{boundary.ndim} / phase ndim {phase.ndim} is neither a "
            "single stream ((H, C, N) + ()) nor a batch "
            "((B, H, C, N) + (B,))"
        )
    got_width = boundary.shape[-3]
    if width is not None and got_width != width:
        raise ValueError(
            f"frontend boundary width {got_width} != expected {width} "
            "(= max(1, overlap)): the saved state comes from a different "
            "overlap setting"
        )
    return FrontendState(
        boundary=torch.tensor(boundary, device=device),
        phase=torch.tensor(phase, device=device),
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
            mats, level=cfg.mspca_level, wavelet_name=cfg.wavelet, halo=halos,
            reference_kernels=cfg.reference_kernels,
        )
        chunk_windows = den.reshape(lead + (n_mat * per, c, n))[..., :w, :, :]
    return features.wpd_features(
        chunk_windows, level=cfg.wpd_level, wavelet_name=cfg.wavelet,
        reference_kernels=cfg.reference_kernels,
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


def scan_stream(
    state: FrontendState, chunks: torch.Tensor, cfg
) -> tuple[FrontendState, torch.Tensor]:
    """``frontend_step`` over a (n_chunks, W, C, N) stream, one chunk after
    the other (the reference's ``lax.scan``). Returns the final state and
    the (n_chunks, W, F) feature rows; ``pipeline.process_windows`` runs
    on it."""
    feats = []
    for chunk in chunks:
        state, f = frontend_step(state, chunk, cfg)
        feats.append(f)
    return state, torch.stack(feats)


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
    take = active.to(torch.int32).sum(dim=1, dtype=torch.int32)  # int32, as phase
    # Last bw raw windows of (boundary ++ chunks[:take]); take == 0 keeps
    # the old boundary.
    rows = torch.arange(b, device=chunks.device)[:, None]
    new_boundary = stream[rows, take[:, None].long() * w + arange_bw]
    return FrontendState(boundary=new_boundary, phase=state.phase + take), feats


class StreamingFrontend:
    """Incremental featurizer of one stream: ``feed`` raw windows in pieces
    of any size; every completed ``chunk_windows``-window chunk goes
    through ``scan_stream`` with the carried state, so the features over a
    stream equal ``pipeline.process_windows`` of the chunk-aligned stream
    bit for bit. The partial chunk stays buffered on the host. Runs on
    ``device`` (CUDA by default)."""

    def __init__(
        self, cfg, chunk_windows: int = eeg_data.WINDOWS_PER_MATRIX, *,
        device: torch.device | str | None = None,
    ):
        self.cfg = cfg
        self.chunk_windows = chunk_windows
        self.device = resolve_device(device)
        self.state = init_state(overlap=cfg.overlap, device=self.device)
        self._buf = np.zeros((0, eeg_data.N_CHANNELS, eeg_data.WINDOW), np.float32)

    @property
    def pending_windows(self) -> int:
        return int(self._buf.shape[0])

    @property
    def chunks_seen(self) -> int:
        return int(self.state.phase)

    def feed(self, windows) -> np.ndarray:
        """Buffer raw (W, C, N) windows (or one (C, N)); featurize every
        completed chunk. Returns (k * chunk_windows, F) feature rows for
        the k chunks this call completed (k may be 0)."""
        if isinstance(windows, torch.Tensor):
            windows = windows.detach().cpu().numpy()
        windows = np.asarray(windows, np.float32)
        if windows.ndim == 2:
            windows = windows[None]
        self._buf = (
            np.concatenate([self._buf, windows]) if self._buf.size else windows.copy()
        )
        per = self.chunk_windows
        n_ready = self._buf.shape[0] // per
        if n_ready == 0:
            return np.zeros(
                (0, features.feature_dim(eeg_data.N_CHANNELS, self.cfg.wpd_level)),
                np.float32,
            )
        ready = self._buf[: n_ready * per].reshape((n_ready, per) + self._buf.shape[1:])
        self._buf = self._buf[n_ready * per :]
        self.state, feats = scan_stream(
            self.state, torch.from_numpy(ready).to(self.device), self.cfg
        )
        return feats.cpu().numpy().reshape(n_ready * per, -1)

    def state_dict(self) -> dict[str, np.ndarray]:
        """The whole resumable state (carried context and the buffered
        partial chunk) as a flat numpy dict, ready for
        ``checkpoint.store.save``."""
        arrays = state_to_arrays(self.state)
        arrays["buf"] = np.array(self._buf, np.float32)
        return arrays

    def load_state_dict(self, arrays: dict) -> None:
        """Resume from a ``state_dict`` (of either package): later ``feed``
        output equals the uninterrupted stream's. A state from another
        overlap setting raises ``ValueError``."""
        self.state = state_from_arrays(
            arrays, width=boundary_width(self.cfg.overlap), device=self.device
        )
        self._buf = np.array(arrays["buf"], np.float32)
