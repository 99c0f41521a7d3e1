"""End-to-end seizure-prediction pipeline (paper Sec. 2.6) in PyTorch: the
twin of ``repro.signal.pipeline``.

  raw windows -> MSPCA denoise (per 8-minute matrix) -> WPD features
  -> rotation forest -> chunk votes -> k-of-m alarm rule.

``PipelineConfig`` has the reference's fields, defaults and field order,
so a program's ``cfg_json`` leaf parses into it and serializes back byte
for byte. ``use_kernel`` is kept for that parity only: the port routes
every kernel by the device its tensors lie on. ``reference_kernels=True``
runs the reference's pre-megabatch formulations (the serving bench's
serial-replay leg): gather-form wavelet analysis level by level,
sample-major PCA with the full-width masked reconstruction, the transpose
synthesis.

``fit`` trains on one device or MapReduce-style (one process per shard
over a ``torch.distributed`` mesh, ``mesh=``, or the shards emulated one
after the other, ``n_shards=``); ``process_recording_mapreduce`` is the
feature map alone over a mesh. ``evaluate_timeline`` scores a
chronological stream through a one-slot ``serving.api.SeizureEngine``, so
offline evaluation and serving share one code path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import forest_trainer
from repro_torch.core import mapreduce as mr
from repro_torch.core import rotation_forest as rf
from repro_torch.core.rotation_forest import RotationForestConfig
from repro_torch.kernels.forest import ops as forest_ops
from repro_torch.signal import eeg_data, features, frontend


class PipelineConfig(NamedTuple):
    wpd_level: int = 4
    wavelet: str = "db4"
    mspca_level: int = 5
    denoise: bool = True
    use_kernel: bool = False
    forest: RotationForestConfig = RotationForestConfig(
        n_trees=10, n_subsets=3, depth=6, n_classes=2, n_bins=32
    )
    # Alarm iff >= alarm_k of the last alarm_m chunks voted preictal.
    alarm_k: int = 3
    alarm_m: int = 5
    # Raw windows of the previous chunk prepended to each MSPCA matrix.
    overlap: int = 0
    reference_kernels: bool = False


class FittedPipeline(NamedTuple):
    forest: rf.RotationForestParams
    feat_mean: torch.Tensor
    feat_std: torch.Tensor


# ---------------------------------------------------------------------------
# Signal processing (the map phase)
# ---------------------------------------------------------------------------

def process_windows(windows: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """(W, C, N) raw windows -> (W, F) feature rows.

    The recording is cut into 8-minute chunks and ``frontend.scan_stream``
    featurizes them in order from a zero context: each chunk is one of the
    paper's 2048 x (60 * C) denoise matrices. A recording that does not
    fill its last chunk is wrap-padded by cyclic tiling (the reference's
    ``jnp.resize``, which also covers a recording shorter than one chunk)
    and the padding rows are dropped.
    """
    w, c, n = windows.shape
    if not cfg.denoise:
        return features.wpd_features(
            windows, level=cfg.wpd_level, wavelet_name=cfg.wavelet,
            reference_kernels=cfg.reference_kernels,
        )
    per = eeg_data.WINDOWS_PER_MATRIX
    n_mat = max(1, -(-w // per))
    padded = frontend._wrap_pad(windows, n_mat * per) if n_mat * per != w else windows
    _, feats = frontend.scan_stream(
        frontend.init_state(c, n, cfg.overlap, device=windows.device),
        padded.reshape(n_mat, per, c, n), cfg,
    )
    return feats.reshape(n_mat * per, -1)[:w]


def process_recording_mapreduce(
    mesh, recording: eeg_data.Recording, cfg: PipelineConfig
) -> torch.Tensor:
    """``process_windows`` over the mesh's ``data`` dimension (the Hadoop
    map of Sec. 2.4): each rank denoises and featurizes its own slice of
    the recording's windows (align the slices with whole 8-minute chunks,
    or each rank wrap-pads its last one), and every rank gets the union
    of the features in rank order."""
    job = mr.MapReduce(lambda wins: process_windows(wins, cfg), mr.reduce_concat, "data")
    return job.run(mesh, recording.windows)


# ---------------------------------------------------------------------------
# Training / prediction
# ---------------------------------------------------------------------------

def fit(
    generator: torch.Generator,
    recording: eeg_data.Recording,
    cfg: PipelineConfig,
    *,
    mesh=None,
    n_shards: int | None = None,
) -> FittedPipeline:
    """Train the pipeline: features -> z-score -> rotation forest, on the
    recording's device (draws from ``generator``, on the same device).

    Default: one whole-recording fit. With ``mesh`` (one process per
    shard along its ``data`` dimension, every rank calling with the same
    recording and generator state) or ``n_shards`` (the shards emulated
    in turn) the fit runs MapReduce-style
    (``core.forest_trainer.fit_mapreduce``): each shard denoises,
    featurizes and fits a sub-forest on its own slice of windows, feature
    moments are global, and the ensemble is the union. With ``denoise``
    on, shard boundaries must fall on whole 8-minute chunks (checked), or
    each shard would wrap-tile a partial matrix.
    """
    if mesh is not None or n_shards is not None:
        shards = mr.mesh_shards(mesh).count if mesh is not None else int(n_shards)
        w = recording.windows.shape[0]
        per = eeg_data.WINDOWS_PER_MATRIX
        if cfg.denoise and shards > 0 and w % shards == 0 and (w // shards) % per != 0:
            raise ValueError(
                f"{w} windows over {shards} shards gives {w // shards} "
                f"windows per shard, not a multiple of "
                f"WINDOWS_PER_MATRIX={per}: each shard would wrap-tile a "
                "partial 8-minute denoise matrix and silently train on "
                "duplicated data. Align shard boundaries to whole chunks "
                "(or set denoise=False)."
            )
        res = forest_trainer.fit_mapreduce(
            generator, recording.windows, recording.labels, cfg.forest,
            mesh=mesh, n_shards=n_shards,
            feature_fn=lambda wins: process_windows(wins, cfg),
        )
        return FittedPipeline(forest=res.forest, feat_mean=res.feat_mean, feat_std=res.feat_std)
    feats = process_windows(recording.windows, cfg)
    feats, mean, std = features.normalize(feats)
    forest = rf.fit(generator, feats, recording.labels, cfg.forest)
    return FittedPipeline(forest=forest, feat_mean=mean, feat_std=std)


def predict_windows(
    fitted: FittedPipeline, windows: torch.Tensor, cfg: PipelineConfig
) -> torch.Tensor:
    """(W, C, N) -> (W,) predicted labels, one per 8-second window."""
    feats, _, _ = features.normalize(
        process_windows(windows, cfg), fitted.feat_mean, fitted.feat_std
    )
    return rf.predict(fitted.forest, feats)


def chunk_predictions(window_preds: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """Window predictions -> 8-minute chunk votes: a chunk is preictal when
    MORE than half its windows are (the paper's "half of total value").
    Trailing windows that do not fill a chunk are dropped. The fraction is
    a count over a division, as the engine takes it."""
    per = eeg_data.WINDOWS_PER_MATRIX
    n_chunks = window_preds.shape[0] // per
    chunks = window_preds[: n_chunks * per].reshape(n_chunks, per)
    frac = chunks.to(torch.float32).sum(dim=1) / per
    return (frac > 0.5).to(torch.int32)


def alarm_state(chunk_preds: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """The k-of-m rule: alarm at chunk t iff >= alarm_k of the last alarm_m
    chunk votes (t inclusive) are preictal; a lagged-cumsum difference."""
    m, k = cfg.alarm_m, cfg.alarm_k
    csum = torch.cumsum(chunk_preds.to(torch.int64), dim=0)
    lagged = torch.cat([torch.zeros((m,), dtype=torch.int64, device=csum.device), csum])
    return ((csum - lagged[: csum.shape[0]]) >= k).to(torch.int32)


class TimelineResult(NamedTuple):
    """``evaluate_timeline``'s result, as host (CPU) tensors."""

    window_preds: torch.Tensor
    chunk_preds: torch.Tensor
    alarms: torch.Tensor
    # Minutes before the seizure at which the first PREDICTIVE alarm fired
    # (-1 = no alarm during the preictal run-up).
    lead_time_minutes: torch.Tensor
    # First truly-preictal chunk (label-derived); -1 if the stream has none.
    onset_chunk: torch.Tensor


def lead_time_from_alarms(alarms, true_chunks) -> torch.Tensor:
    """Minutes of warning the alarm sequence earned, the paper's way.

    ``true_chunks[t] == 1`` marks the label-derived preictal run-up; the
    seizure is the END of the stream. The lead counts from the first alarm
    at or after the first truly-preictal chunk, in whole chunks of 8
    minutes (chunk-start convention). An alarm that only fired earlier is
    a false positive, and a stream with no preictal chunk has nothing to
    predict: both score -1.
    """
    alarms = torch.as_tensor(alarms, dtype=torch.int32)
    true_chunks = torch.as_tensor(true_chunks, dtype=torch.int32, device=alarms.device)
    n_chunks = alarms.shape[0]
    has_onset = (true_chunks == 1).any()
    onset = torch.argmax(true_chunks)
    predictive = (alarms == 1) & (torch.arange(n_chunks, device=alarms.device) >= onset)
    first_alarm = torch.argmax(predictive.to(torch.int32))
    lead = (n_chunks - first_alarm).to(torch.float32) * 8.0
    return torch.where(has_onset & predictive.any(), lead, torch.tensor(-1.0, device=lead.device))


def evaluate_timeline(
    fitted: FittedPipeline, recording: eeg_data.Recording, cfg: PipelineConfig
) -> TimelineResult:
    """Run the real-time protocol over a chronological test stream:
    ``evaluate_program`` of the fitted pipeline's ``ScoringProgram``."""
    from repro_torch.serving import api  # deferred: serving.api imports us

    return evaluate_program(api.ScoringProgram.from_fitted(fitted, cfg), recording)


def evaluate_program(program, recording: eeg_data.Recording) -> TimelineResult:
    """Score a chronological stream through a one-slot ``SeizureEngine``
    on the program's device (replay depth 8, the whole recording pushed
    as one backlog), so the chunk votes and alarms are by construction
    what serving emits. Trailing windows that do not fill a chunk get
    window predictions only, from a self-wrapped denoise with a
    stream-start context (as the reference)."""
    from repro_torch.serving import api

    cfg = program.cfg
    engine = api.SeizureEngine(
        program, max_batch=1, replay_depth=8, device=program.feat_mean.device
    )
    session = engine.open_session(0)
    session.push(recording.windows)
    scored = [e for e in engine.poll() if isinstance(e, api.ChunkScored)]
    chunks = torch.tensor([e.chunk_pred for e in scored], dtype=torch.int32)
    alarms = torch.tensor([e.alarm for e in scored], dtype=torch.int32)

    window_preds = [e.window_preds for e in scored]
    if session.pending_windows:
        tail = recording.windows[len(scored) * eeg_data.WINDOWS_PER_MATRIX :]
        normed, _, _ = features.normalize(
            process_windows(tail, cfg), engine.program.feat_mean, engine.program.feat_std
        )
        probs = forest_ops.forest_predict_proba(engine.program.packed, normed)
        window_preds.append(torch.argmax(probs, dim=-1).cpu().numpy())
    preds = torch.from_numpy(np.concatenate(window_preds).astype(np.int32))

    true_chunks = chunk_predictions(recording.labels.cpu(), cfg)
    onset = torch.argmax(true_chunks) if (true_chunks == 1).any() else torch.tensor(-1)
    return TimelineResult(
        window_preds=preds, chunk_preds=chunks, alarms=alarms,
        lead_time_minutes=lead_time_from_alarms(alarms, true_chunks),
        onset_chunk=onset,
    )
