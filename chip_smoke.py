#!/usr/bin/env python3
"""Drive the PyTorch port of the seizure-scoring and training paths on one
CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. Device: the card's name and power limit from nvidia-smi; the kernel
     library is built from ``src/repro_torch/csrc`` (nvcc, first use).
  2. Kernels: K1 forest, K2 wpd_level and K3 gram against their plain
     PyTorch versions at the scoring path's shapes, each with its error,
     its time, the plain version's time, one PyTorch library call's time
     where one computes the same function, and its bound on this card
     (K4 histogram likewise in phase 6, at the grower's shapes).
  3. Engine: the committed full-width program serves 8 sessions of
     generated EEG (6 chunks each, pushed in chunk-unaligned pieces) at
     max_batch=8, replay_depth=4, at overlap 0 and at overlap 2; every
     kernel's launch count must be > 0 after each run.
  4. Kernel path vs plain path: the same traffic through the engine with
     the plain versions; events must agree exactly in type, patient,
     chunk index, chunk vote and alarm, and a window prediction may
     differ only where its routing margin is below 1e-3 (z-units).
  5. Stage times of one engine step (the six eigh calls of one denoise
     among them), a profiler trace of one step (device busy and idle
     share, device time by kernel).
  6. Training: a MapReduce fit of the default ``PipelineConfig`` (10
     trees of depth 6, 32 bins, F = 288) over 2 shards of 16 + 16
     stratified generated chunks, timed by stage (feature extraction and
     its MSPCA eigh, K2 and K3 calls; rotation and its eigh; grower and
     its K4 calls). K2 and K3 are held against their plain versions on
     every input shape the fit gave them, and one shard's training
     features through the kernels may lie at most twice as far from the
     host CPU's features as the plain path's do (z-units, 99th and 99.9th
     percentile).
     K4 must launch once per level and shard (12 times), and equal its
     plain version exactly on the grower's 0/1 masses (and within 1e-5
     relative on float weights), and on a 65536-bucket histogram built in
     shared-memory slices.
     The fit is checkpointed, reloaded and served on a held-out timeline
     (1 h interictal, the 48-minute run-up, the seizure) pushed 37
     windows at a time; the served alarms must equal
     ``pipeline.evaluate_timeline``, and the port-trained forest's window
     accuracy may trail the committed JAX-trained program's by at most
     0.05. A retrain on fresh shards is swapped into the running engine
     mid-stream; version stamps and the composite old/new alarm oracle
     must be exact.
  7. A ``kernels`` JSON line, the card line, and the last line
     ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM
# bandwidth and float32 outside the tensor cores (the kernels run true
# float32 on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

SEED = 0
N_SESSIONS = 8
CHUNKS_PER_SESSION = 6
MAX_BATCH = 8
REPLAY_DEPTH = 4
PUSH_CUTS = (0, 97, 150, 245, 270, 333, 360)  # chunk-unaligned push pieces
TRAIN_PATIENT = 3
TRAIN_CHUNKS_PER_CLASS = 16
TRAIN_SHARDS = 2
PUSH = 37  # windows per push when serving the held-out timeline


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, launches: int = 20, reps: int = 7, warmup: int = 3) -> float:
    """Time of one ``fn()`` call: CUDA events around ``launches``
    back-to-back calls, divided by the count; the median over ``reps``
    such groups, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_versions():
    """Route CUDA tensors to the plain versions for the duration (the
    wrappers' kernel entries are swapped for the ref functions)."""
    from repro_torch.kernels.forest import kernel as fk, ref as fr
    from repro_torch.kernels.gram import kernel as gk, ref as gr
    from repro_torch.kernels.histogram import kernel as hk, ref as hr
    from repro_torch.kernels.wpd import kernel as wk, ref as wr

    saved = (fk.forest_traverse, gk.gram, wk.wpd_level, hk.class_histogram)
    fk.forest_traverse, gk.gram, wk.wpd_level, hk.class_histogram = (
        fr.forest_traverse, gr.gram, wr.wpd_level, hr.class_histogram
    )
    try:
        yield
    finally:
        fk.forest_traverse, gk.gram, wk.wpd_level, hk.class_histogram = saved


def _kernel_modules() -> dict:
    from repro_torch.kernels.forest import kernel as fk
    from repro_torch.kernels.gram import kernel as gk
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.wpd import kernel as wk

    return {"forest": fk, "wpd_level": wk, "gram": gk, "histogram": hk}


def launch_counts() -> dict[str, int]:
    return {name: mod.LAUNCHES for name, mod in _kernel_modules().items()}


def reset_counts() -> None:
    for mod in _kernel_modules().values():
        mod.LAUNCHES = 0


def path_walk(x, packed):
    """Walk every row down every tree. Returns the (rows,) routing margin,
    min over trees and live path nodes of |x . proj - thr| (how far each
    row is from flipping a route), and the number of live (finite-thr)
    nodes the rows visit in all: the node values the forest needs."""
    import torch

    vals = torch.einsum("bf,tfl->tbl", x, packed.proj)
    rows = torch.arange(x.shape[0], device=x.device)
    out = torch.full((x.shape[0],), float("inf"), device=x.device)
    live = 0
    depth = packed.proj.shape[-1].bit_length() - 1
    for t in range(packed.proj.shape[0]):
        node = torch.ones(x.shape[0], dtype=torch.long, device=x.device)
        for _ in range(depth):
            v, th = vals[t, rows, node], packed.thr[t, node]
            finite = torch.isfinite(th)
            live += int(finite.sum())
            out = torch.minimum(out, torch.where(finite, (v - th).abs(), torch.inf))
            node = 2 * node + (v > th).long()
    return out, live


def wpd_row(xr) -> dict:
    """K2 against its plain version on xr (rows, N) with the db4 filters
    (max abs error <= 1e-5 * max|x|), timed beside conv1d and its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.wpd import kernel as wk, ref as wr
    from repro_torch.signal import wavelet

    h, g = wavelet.filters("db4")  # host taps, as the wavelet module passes them
    weight = torch.stack([h, g])[:, None, :].to(xr.device)  # (2, 1, taps)
    taps = h.shape[0]
    (ka, kd), (pa, pd) = wk.wpd_level(xr, h, g), wr.wpd_level(xr, h, g)
    torch.cuda.synchronize()
    err = max(float((ka - pa).abs().max()), float((kd - pd).abs().max()))
    tol = 1e-5 * float(xr.abs().max())
    if not err <= tol:
        fail(f"wpd_level kernel {tuple(xr.shape)} disagrees with its plain version: "
             f"{err} > {tol}")

    def conv():
        return F.conv1d(F.pad(xr[:, None, :], (0, taps - 2), mode="circular"),
                        weight, stride=2)

    b_ms, b_by = bound_ms(4 * 2 * xr.numel(), 2.0 * taps * xr.numel())
    return dict(
        shape=f"x {tuple(xr.shape)}", max_abs_err=err, tol=tol,
        ms=time_ms(lambda: wk.wpd_level(xr, h, g)),
        plain_ms=time_ms(lambda: wr.wpd_level(xr, h, g)),
        library_ms=time_ms(conv), bound_ms=b_ms, bound_by=b_by,
    )


def gram_row(xv) -> dict:
    """K3 against its plain version on xv (..., n, P), as given (pca.fit_T
    hands over a transposed view): max abs error <= 1e-5 * max|G|, timed
    beside torch.matmul and its bound."""
    import torch

    from repro_torch.kernels.gram import kernel as gk, ref as gr

    got, want = gk.gram(xv), gr.gram(xv)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-5 * float(want.abs().max())
    if not err <= tol:
        fail(f"gram kernel {tuple(xv.shape)} disagrees with its plain version: "
             f"{err} > {tol}")
    n, p = xv.shape[-2:]
    batch = xv.numel() // (n * p)
    # G is symmetric: p (p + 1) / 2 sums of n products per matrix.
    b_ms, b_by = bound_ms(4 * (xv.numel() + batch * p * p), 1.0 * batch * n * p * (p + 1))
    view = "" if xv.is_contiguous() else " (transposed view)"
    return dict(
        shape=f"x {tuple(xv.shape)}{view}", max_abs_err=err, tol=tol,
        ms=time_ms(lambda: gk.gram(xv)),
        plain_ms=time_ms(lambda: gr.gram(xv)),
        library_ms=time_ms(lambda: torch.matmul(xv.transpose(-1, -2), xv)),
        bound_ms=b_ms, bound_by=b_by,
    )


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(program, gen) -> dict[str, dict]:
    import torch

    from repro_torch.kernels.forest import kernel as fk, ref as fr

    dev = torch.device("cuda")
    rows = {}

    # K1: the z-scored feature rows of one engine step, B*D*60 = 1920.
    packed = program.packed
    f = packed.proj.shape[1]
    x = torch.randn((MAX_BATCH * REPLAY_DEPTH * 60, f), generator=gen, device=dev)
    args = (x, packed.proj, packed.thr, packed.leaf_probs)
    got, want = fk.forest_traverse(*args), fr.forest_traverse(*args)
    torch.cuda.synchronize()
    margin, live_nodes = path_walk(x, packed)
    safe = margin >= 1e-4
    err = float((got - want).abs()[safe].max())
    flipped = int((~safe).sum())
    n_classes = packed.leaf_probs.shape[-1]
    tol = 1e-6
    # The function needs one dot product per live node on each row's path
    # (the kernel computes every node column; the bound counts what the
    # data needs).
    b_ms, b_by = bound_ms(
        4 * (x.numel() + packed.proj.numel() + packed.thr.numel()
             + packed.leaf_probs.numel() + x.shape[0] * n_classes),
        2.0 * f * live_nodes,
    )
    rows["forest"] = dict(
        shape=f"x {tuple(x.shape)}, proj {tuple(packed.proj.shape)}",
        max_abs_err=err, tol=tol,
        note=f"{flipped} rows with margin < 1e-4 excluded; {live_nodes} live path nodes",
        ms=time_ms(lambda: fk.forest_traverse(*args)),
        plain_ms=time_ms(lambda: fr.forest_traverse(*args)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
    )
    if not err <= tol:
        fail(f"forest kernel disagrees with its plain version: {err} > {tol}")

    # K2: the first WPD level of one step (5760 rows of 2048) and the
    # second (1024); MSPCA's DWT runs the same operator.
    for n in (2048, 1024):
        xr = torch.randn((MAX_BATCH * REPLAY_DEPTH * 60 * 3, n), generator=gen, device=dev)
        rows[f"wpd_level/{n}"] = wpd_row(xr)

    # K3: MSPCA's finest and coarsest per-scale covariances of one step,
    # passed as the transposed view pca.fit_T hands over.
    for n, p in ((1024, 180), (64, 186)):
        xt = torch.randn((MAX_BATCH * REPLAY_DEPTH, p, n), generator=gen, device=dev)
        rows[f"gram/{n}x{p}"] = gram_row(xt.transpose(1, 2))

    print_kernel_rows(rows)
    return rows


# ---------------------------------------------------------------------------
# Phases 3-4: the engine, kernel path and plain path
# ---------------------------------------------------------------------------

def make_traffic(gen):
    """{patient_id: (360, 3, 2048) float32 numpy}: half the patients stay
    interictal, half turn preictal for their last 3 chunks."""
    import torch

    from repro_torch.signal import eeg_data

    per = eeg_data.WINDOWS_PER_MATRIX
    traffic = {}
    for i in range(N_SESSIONS):
        pid = 3 + 10 * i  # the training patient's regime family (odd, id % 5 == 3)
        if i % 2 == 0:
            w = eeg_data.generate_windows(gen, pid, eeg_data.INTERICTAL, CHUNKS_PER_SESSION * per)
        else:
            half = CHUNKS_PER_SESSION // 2 * per
            w = torch.cat([
                eeg_data.generate_windows(gen, pid, eeg_data.INTERICTAL, half),
                eeg_data.generate_windows(gen, pid, eeg_data.PREICTAL, half),
            ])
        traffic[pid] = w.cpu().numpy()
    return traffic


def drive(program, traffic) -> tuple[list, dict]:
    import torch

    from repro_torch.serving import api

    engine = api.SeizureEngine(
        program, max_batch=MAX_BATCH, replay_depth=REPLAY_DEPTH, device="cuda"
    )
    sessions = {pid: engine.open_session(pid) for pid in traffic}
    events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo, hi in zip(PUSH_CUTS[:-1], PUSH_CUTS[1:]):
        for pid, s in sessions.items():
            s.push(traffic[pid][lo:hi])
        events += engine.poll(drain=False)
    events += engine.poll()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    scored = [e for e in events if isinstance(e, api.ChunkScored)]
    stats = dict(
        steps=engine.steps, chunks=len(scored), seconds=seconds,
        windows_per_s=len(scored) * engine.chunk_windows / seconds,
        alarms={pid: engine.alarm_state(pid) for pid in traffic},
    )
    return events, stats


def chunk_margins(program, traffic, pid, k):
    import torch

    from repro_torch.signal import features, frontend

    per, ov = 60, program.cfg.overlap
    stream = torch.from_numpy(traffic[pid]).to("cuda")
    chunk = stream[k * per:(k + 1) * per]
    halo = None
    if ov:
        halo = stream[k * per - ov:k * per] if k else torch.zeros_like(chunk[:ov])
        halo = halo[None]
    feats = frontend.chunk_features(chunk[None], program.cfg, halo=halo)[0]
    x, _, _ = features.normalize(feats, program.feat_mean, program.feat_std)
    return path_walk(x, program.packed)[0].cpu().numpy()


def compare_events(got, want, program, traffic) -> int:
    """Events equal under the rule; returns the number of window
    predictions that differ (each checked against its margin)."""
    from repro_torch.serving import api

    if [type(e).__name__ for e in got] != [type(e).__name__ for e in want]:
        fail("kernel path and plain path emit different event sequences")
    differing = 0
    for g, w in zip(got, want):
        if not isinstance(w, api.ChunkScored):
            if tuple(g) != tuple(w):
                fail(f"alarm events differ: {g} vs {w}")
            continue
        if (g.patient_id, g.chunk_index, g.chunk_pred, g.alarm) != (
                w.patient_id, w.chunk_index, w.chunk_pred, w.alarm):
            fail(f"chunk events differ: {g[:5]} vs {w[:5]}")
        bad = (g.window_preds != w.window_preds).nonzero()[0]
        if bad.size:
            with plain_versions():
                margins = chunk_margins(program, traffic, w.patient_id, w.chunk_index)
            if not (margins[bad] < 1e-3).all():
                fail(f"window predictions differ at margins {margins[bad]}")
            differing += bad.size
    return differing


def step_inputs(program, traffic):
    """One full engine step's arguments at (B, D) = (8, 4): the traffic's
    first 4 chunks of each session."""
    import torch

    from repro_torch.serving import api

    chunks = torch.from_numpy(np.stack([
        traffic[pid][:REPLAY_DEPTH * 60].reshape(REPLAY_DEPTH, 60, 3, -1)
        for pid in list(traffic)[:MAX_BATCH]
    ])).to("cuda")  # (B, D, 60, 3, 2048)
    state = api.init_state(MAX_BATCH, program.cfg.alarm_m, device="cuda")
    active = torch.ones((MAX_BATCH, REPLAY_DEPTH), dtype=torch.int32, device="cuda")
    return (state, chunks, active, program.packed, program.feat_mean,
            program.feat_std)


def denoise_covariances(chunks):
    """The covariances one denoise of the (B, D, ...) chunks hands to
    eigh, one batch per wavelet scale."""
    from repro_torch.core import pca
    from repro_torch.signal import mspca

    covs, eig_sorted = [], pca._eig_sorted

    def capture(cov):
        covs.append(cov.clone())
        return eig_sorted(cov)

    pca._eig_sorted = capture
    try:
        mspca.denoise_windows(chunks.reshape(-1, *chunks.shape[2:]))
    finally:
        pca._eig_sorted = eig_sorted
    return covs


def eighs(covs) -> None:
    import torch

    for c in covs:
        torch.linalg.eigh(c)


def stage_times(program, traffic) -> dict[str, float]:
    """CUDA-event medians of one full engine step and of its stages."""
    from repro_torch.serving import api
    from repro_torch.signal import features, mspca

    args = step_inputs(program, traffic)
    chunks = args[1]
    flat = chunks.reshape(-1, *chunks.shape[2:])
    feats = features.wpd_features(flat)
    covs = denoise_covariances(chunks)
    shapes = sorted({tuple(c.shape) for c in covs})

    once = dict(launches=1, reps=5, warmup=1)
    return {
        f"engine step (_engine_step_megabatch, {flat.shape[0]} chunks)": time_ms(
            lambda: api._engine_step_megabatch(*args, cfg=program.cfg), **once),
        f"mspca.denoise_windows ({flat.shape[0]} chunks)": time_ms(
            lambda: mspca.denoise_windows(flat), **once),
        f"torch.linalg.eigh of one denoise ({len(covs)} calls on {shapes})": time_ms(
            lambda: eighs(covs), **once),
        f"features.wpd_features ({flat.shape[0]} chunks)": time_ms(
            lambda: features.wpd_features(flat), launches=5, reps=5),
        f"_vote_chunks (normalize + forest + vote, {feats.shape[0] * feats.shape[1]} rows)":
            time_ms(lambda: api._vote_chunks(
                feats, program.packed, program.feat_mean, program.feat_std)),
    }


def device_activity(fn, trace_name: str):
    """Profile one ``fn()`` (after one warm-up call). Returns the host wall
    time in ms (profiler on), the device's busy time in ms (the union of
    its activity intervals) and {name: [device ms, count]} per kernel or
    copy; None for the last two if the profiler saw no device activity.
    The trace goes to ``chiprun_out/<trace_name>.json.gz``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    raw = out / f"{trace_name}.json"
    prof.export_chrome_trace(str(raw))
    with open(raw, "rb") as src, gzip.open(f"{raw}.gz", "wb") as dst:
        dst.write(src.read())
    raw.unlink()

    device = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not device:
        return wall_ms, None, None
    busy_us, end_us = 0.0, float("-inf")
    by_name: dict[str, list] = {}
    for e in device:
        lo, hi = max(e.time_range.start, end_us), e.time_range.end
        busy_us += max(0.0, hi - lo)
        end_us = max(end_us, hi)
        r = by_name.setdefault(e.name, [0.0, 0])
        r[0] += e.time_range.elapsed_us() / 1e3
        r[1] += 1
    return wall_ms, busy_us / 1e3, by_name


def trace_step(program, traffic) -> None:
    """Device busy and idle share of one engine step and of the eigh calls
    of one denoise, and the step's device time by kernel."""
    from repro_torch.serving import api

    args = step_inputs(program, traffic)
    covs = denoise_covariances(args[1])
    for what, fn, name in (
        ("one engine step", lambda: api._engine_step_megabatch(*args, cfg=program.cfg),
         "engine_step_trace"),
        (f"the {len(covs)} eigh calls of one denoise", lambda: eighs(covs), "eigh_trace"),
    ):
        wall_ms, busy_ms, by_name = device_activity(fn, name)
        if busy_ms is None:
            print(f"trace {what}: {wall_ms:.3f} ms wall; the profiler recorded no "
                  "device activity: busy and idle share not measured")
            continue
        print(f"trace {what}: {wall_ms:.3f} ms wall (profiler on), device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
              f"{sum(n for _, n in by_name.values())} device activities")
        if name != "engine_step_trace":
            continue
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        ours = [kv for kv in ranked
                if any(k in kv[0] for k in ("forest_kernel", "gram_kernel", "wpd_level_kernel"))]
        for kname, (ms, n) in ranked[:10] + ours:
            print(f"trace kernel: {ms:.3f} ms in {n} launches: {kname[:110]}")


# ---------------------------------------------------------------------------
# Phase 6: training on the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def stage_clock(stages: dict, owner, name: str, label: str, hook=None):
    """Add the synchronized wall time of every call of ``owner.name`` to
    ``stages[label]`` for the duration (``hook(args)`` sees each call's
    arguments)."""
    import torch

    fn = getattr(owner, name)
    stages.setdefault(label, 0.0)

    def timed(*args, **kwargs):
        if hook is not None:
            hook(args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stages[label] += time.perf_counter() - t0
        return out

    setattr(owner, name, timed)
    try:
        yield
    finally:
        setattr(owner, name, fn)


def training_set(gen):
    from repro_torch.signal import eeg_data

    per = eeg_data.WINDOWS_PER_MATRIX
    return eeg_data.stratify_chunks(eeg_data.make_training_set(
        gen, TRAIN_PATIENT, n_interictal_windows=TRAIN_CHUNKS_PER_CLASS * per,
        n_preictal_windows=TRAIN_CHUNKS_PER_CLASS * per,
    ))


def timed_fit(gen, rec, cfg):
    """One MapReduce fit with its stage times (seconds) and the kernels'
    inputs as the fit handed them over: {"histogram": {n_buckets: (codes,
    wy)}, "wpd_level": {shape: x}, "gram": {shape: x}}, the last call per
    bucket count and the first per shape."""
    import torch

    from repro_torch.core import decision_tree as dt
    from repro_torch.core import pca
    from repro_torch.core import rotation_forest as rf
    from repro_torch.kernels.gram import kernel as gk
    from repro_torch.kernels.histogram import ops as hist_ops
    from repro_torch.kernels.wpd import kernel as wk
    from repro_torch.signal import pipeline

    stages: dict[str, float] = {}
    captured: dict[str, dict] = {"histogram": {}, "wpd_level": {}, "gram": {}}
    with contextlib.ExitStack() as stack:
        for owner, name, label, hook in (
            (pipeline, "process_windows", "feature extraction (MSPCA + WPD)", None),
            (pca, "_eig_sorted", "of which MSPCA eigh (pca._eig_sorted)", None),
            (wk, "wpd_level", "of which K2 wpd_level (DWT and WPD levels)",
             lambda a: captured["wpd_level"].setdefault(tuple(a[0].shape), a[0])),
            (gk, "gram", "of which K3 gram (MSPCA covariances)",
             lambda a: captured["gram"].setdefault(tuple(a[0].shape), a[0])),
            (rf, "_prepare_trees", "tree prep (rotation, x @ R, binning)", None),
            (rf, "_build_rotation", "of which rotation", None),
            (rf, "_block_components", "of which rotation eigh", None),
            (dt, "fit_forest_binned", "grower", None),
            (hist_ops, "class_histogram", "of which K4 histogram",
             lambda a: captured["histogram"].__setitem__(a[2], (a[0], a[1]))),
        ):
            stack.enter_context(stage_clock(stages, owner, name, label, hook))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fitted = pipeline.fit(gen, rec, cfg, n_shards=TRAIN_SHARDS)
        torch.cuda.synchronize()
        stages["fit"] = time.perf_counter() - t0
    return fitted, stages, captured


def _z_units(got, want) -> dict[str, float]:
    """|got - want| over want's per-feature std: max, 99.9th and 99th
    percentile, and median over all entries."""
    import torch

    z = ((got - want).abs() / (want.std(dim=0) + 1e-6)).flatten()
    q = torch.quantile(z, torch.tensor([0.5, 0.99, 0.999], device=z.device)).tolist()
    return dict(max=float(z.max()), p999=q[2], p99=q[1], median=q[0])


def check_fit_features(captured, rec, cfg) -> None:
    """K2 and K3 against their plain versions on every input shape the fit
    handed them (the tolerances of phase 2); then one shard's training
    features three ways: through the kernels, through the plain versions
    on the card, and through the port on the host CPU (LAPACK's eigh,
    the path the CPU tests hold to the reference). MSPCA's eigh turns the
    float32 rounding differences of any two paths into feature
    differences, largest in the chunks whose kept subspace is nearly
    degenerate, so the kernel path is held to the card's own plain path:
    its distance from the CPU features, in z-units (difference over the
    CPU features' per-feature std), may be at most twice the plain
    path's at the 99th and the 99.9th percentile. A kernel that is wrong
    everywhere moves the first, one wrong in a feature or a chunk the
    second."""
    from repro_torch.signal import pipeline

    rows = {f"wpd_level/fit {tuple(x.shape)}": wpd_row(x)
            for x in captured["wpd_level"].values()}
    rows.update({f"gram/fit {tuple(x.shape)}": gram_row(x)
                 for x in captured["gram"].values()})
    print_kernel_rows(rows)
    shard = rec.windows[: rec.windows.shape[0] // TRAIN_SHARDS]
    kernel = pipeline.process_windows(shard, cfg)
    with plain_versions():
        plain = pipeline.process_windows(shard, cfg)
    host = pipeline.process_windows(shard.cpu(), cfg)
    z = {
        "kernel vs plain": _z_units(kernel, plain),
        "kernel vs CPU": _z_units(kernel.cpu(), host),
        "plain vs CPU": _z_units(plain.cpu(), host),
    }
    for pair, r in z.items():
        print(f"train features, shard 0 ({shard.shape[0]} windows -> {tuple(kernel.shape)}), "
              f"{pair}: z-units max {r['max']:.3e}, p99.9 {r['p999']:.3e}, "
              f"p99 {r['p99']:.3e}, median {r['median']:.3e}")
    for q in ("p99", "p999"):
        if not z["kernel vs CPU"][q] <= 2 * z["plain vs CPU"][q]:
            fail(f"training features through the kernels are {z['kernel vs CPU'][q]} z-units "
                 f"({q}) from the CPU port's, more than twice the plain path's "
                 f"{z['plain vs CPU'][q]}")


def check_histogram(captured, gen) -> dict[str, dict]:
    """K4 against its plain version on the grower's own level-0 and
    deepest-level inputs: exact on its 0/1 masses, within 1e-5 relative on
    random float weights."""
    import torch

    from repro_torch.kernels.histogram import kernel as hk, ref as hr

    rows = {}
    for n_buckets in (max(captured), min(captured)):
        codes, wy = (v.contiguous() for v in captured[n_buckets])
        t, n, f = codes.shape
        c = wy.shape[-1]
        got, want = hk.class_histogram(codes, wy, n_buckets), hr.class_histogram(codes, wy, n_buckets)
        wf = torch.rand(wy.shape, generator=gen, device=wy.device)
        got_f, want_f = hk.class_histogram(codes, wf, n_buckets), hr.class_histogram(codes, wf, n_buckets)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel_f = float((got_f - want_f).abs().max() / want_f.abs().max())
        if err != 0.0:
            fail(f"histogram kernel ({n_buckets} buckets) differs from its plain version "
                 f"on 0/1 masses by {err}")
        if not rel_f <= 1e-5:
            fail(f"histogram kernel ({n_buckets} buckets) on float weights: relative "
                 f"error {rel_f} > 1e-5")
        # The library yardstick: one index_put_ accumulate of the same
        # scatter (out-of-range codes to a spill bucket).
        safe = torch.where((codes >= 0) & (codes < n_buckets), codes, n_buckets).long()
        dev = codes.device
        index = (torch.arange(t, device=dev)[:, None, None, None],
                 torch.arange(f, device=dev)[None, None, :, None],
                 safe[..., None], torch.arange(c, device=dev))
        values = wy[:, :, None, :].expand(t, n, f, c)

        def library():
            return torch.zeros((t, f, n_buckets + 1, c), device=dev).index_put_(
                index, values, accumulate=True)

        lib = library()[:, :, :n_buckets]
        if not torch.equal(lib, want):
            fail("index_put_ yardstick disagrees with the plain histogram")
        # Bytes: codes and wy read once, the histogram written once; one add
        # per sample, feature and class.
        b_ms, b_by = bound_ms(4 * (codes.numel() + wy.numel() + t * f * n_buckets * c),
                              1.0 * codes.numel() * c)
        rows[f"histogram/{n_buckets}"] = dict(
            shape=f"codes {tuple(codes.shape)}, wy {tuple(wy.shape)}, {n_buckets} buckets",
            max_abs_err=err, tol=0.0,
            note=f"float weights: relative error {rel_f:.2e} (tol 1e-5)",
            ms=time_ms(lambda: hk.class_histogram(codes, wy, n_buckets)),
            plain_ms=time_ms(lambda: hr.class_histogram(codes, wy, n_buckets)),
            library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
        )
    # Beyond one block's shared memory: a depth-12 grower's deepest level
    # at 32 bins (65536 buckets x 2 classes = 512 KB) is built in bucket
    # slices. 16 features keep the output at 42 MB.
    t, n, f, nb = 5, 960, 16, 65536
    codes = torch.randint(-1, nb + 1, (t, n, f), generator=gen, device=gen.device,
                          dtype=torch.int32)
    boot = (torch.rand((t, n, 1), generator=gen, device=gen.device) < 0.632).float()
    label = torch.randint(0, 2, (n,), generator=gen, device=gen.device)
    wy = boot * torch.nn.functional.one_hot(label, 2).float()
    err = float((hk.class_histogram(codes, wy, nb) - hr.class_histogram(codes, wy, nb)).abs().max())
    print(f"kernel histogram/{nb}: codes {(t, n, f)}, in bucket slices: max_abs_err {err:.3e} "
          "(tol 0)")
    if err != 0.0:
        fail(f"histogram kernel ({nb} buckets, sliced) differs from its plain version by {err}")
    print_kernel_rows(rows)
    return rows


def serve_timeline(engine, patient, windows, lo, hi) -> list:
    """Push windows[lo:hi] PUSH at a time, polling after each; the scored
    chunk events."""
    from repro_torch.serving import api

    session = engine.session(patient) or engine.open_session(patient)
    events = []
    for i in range(lo, hi, PUSH):
        session.push(windows[i:min(i + PUSH, hi)])
        events += engine.poll()
    return [e for e in events if isinstance(e, api.ChunkScored)]


def training_phase(gen, committed) -> tuple[dict, dict]:
    """Phase 6. Returns the K4 rows and every kernel's launches in the
    first fit."""
    import tempfile

    import torch

    from repro_torch.serving import api
    from repro_torch.signal import eeg_data, pipeline

    cfg = pipeline.PipelineConfig()
    rec = training_set(gen)
    n_train = rec.windows.shape[0]
    print(f"train data: {n_train} windows {tuple(rec.windows.shape[1:])} "
          f"({rec.windows.numel() * 4 / 1e6:.1f} MB), {int(rec.labels.sum())} preictal, "
          f"cfg {cfg}")
    reset_counts()
    fitted, stages, captured = timed_fit(gen, rec, cfg)
    counts = launch_counts()
    n_levels = cfg.forest.depth * TRAIN_SHARDS
    print(f"train fit: {TRAIN_SHARDS} shards -> {fitted.forest.rotation.shape[0]} trees, "
          f"{stages['fit']:.3f} s, {n_train / stages['fit']:.1f} training windows/s; "
          f"launches {counts}")
    for label, sec in stages.items():
        if label != "fit":
            print(f"train stage {label}: {sec:.3f} s ({sec / stages['fit']:.1%} of the fit)")
    if counts["histogram"] != n_levels:
        fail(f"K4 launched {counts['histogram']} times in the fit, expected {n_levels}")
    if min(counts[k] for k in ("wpd_level", "gram")) == 0:
        fail(f"a feature kernel of the fit never launched: {counts}")
    if fitted.forest.rotation.shape[0] != cfg.forest.n_trees:
        fail(f"union forest has {fitted.forest.rotation.shape[0]} trees")
    check_fit_features(captured, rec, cfg)
    rows = check_histogram(captured["histogram"], gen)

    # Checkpoint, reload, serve a held-out timeline.
    with tempfile.TemporaryDirectory(prefix="seizure_program_") as directory:
        api.ScoringProgram.from_fitted(fitted, cfg).save(directory)
        program = api.ScoringProgram.load(directory, device="cuda")
    timeline = eeg_data.make_test_timeline(gen, TRAIN_PATIENT, hours_interictal=1)
    wins = timeline.windows.cpu().numpy()
    per = eeg_data.WINDOWS_PER_MATRIX
    n_chunks = wins.shape[0] // per
    engine = api.SeizureEngine(program, max_batch=4, replay_depth=4, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scored = serve_timeline(engine, TRAIN_PATIENT, wins, 0, wins.shape[0])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    res = pipeline.evaluate_timeline(fitted, timeline, cfg)
    if [e.alarm for e in scored] != res.alarms.tolist() or len(scored) != n_chunks:
        fail(f"served alarms {[e.alarm for e in scored]} != evaluate_timeline "
             f"{res.alarms.tolist()}")
    labels = timeline.labels.cpu()
    acc = float((res.window_preds == labels).float().mean())
    ref = pipeline.evaluate_program(committed, timeline)
    ref_acc = float((ref.window_preds == labels).float().mean())
    print(f"serve held-out: {wins.shape[0]} windows ({n_chunks} chunks) in {serve_s:.3f} s, "
          f"{engine.steps} steps; served alarms == evaluate_timeline "
          f"{res.alarms.tolist()}; window accuracy {acc:.4f}, lead time "
          f"{float(res.lead_time_minutes):.0f} min; committed JAX-trained program: "
          f"accuracy {ref_acc:.4f}, lead time {float(ref.lead_time_minutes):.0f} min, "
          f"alarms {ref.alarms.tolist()}")
    if acc < ref_acc - 0.05:
        fail(f"port-trained accuracy {acc:.4f} trails the committed program's "
             f"{ref_acc:.4f} by more than 0.05")

    # Retrain on fresh shards, swap into the running engine mid-stream.
    fitted2, stages2, _ = timed_fit(gen, training_set(gen), cfg)
    k_swap = n_chunks // 2
    scored2 = serve_timeline(engine, TRAIN_PATIENT + 1000, wins, 0, k_swap * per)
    version = engine.swap_program(api.ScoringProgram.from_fitted(fitted2, cfg))
    scored2 += serve_timeline(engine, TRAIN_PATIENT + 1000, wins, k_swap * per, n_chunks * per)
    versions = [e.program_version for e in scored2]
    if versions != [0] * k_swap + [version] * (n_chunks - k_swap):
        fail(f"program_version stamps wrong: {versions}")
    res2 = pipeline.evaluate_timeline(fitted2, timeline, cfg)
    combined = torch.cat([res.chunk_preds[:k_swap], res2.chunk_preds[k_swap:n_chunks]])
    want = pipeline.alarm_state(combined, cfg).tolist()
    if [e.alarm for e in scored2] != want:
        fail(f"post-swap alarms {[e.alarm for e in scored2]} != composite oracle {want}")
    changed = int((res.chunk_preds != res2.chunk_preds).sum())
    print(f"retrain + swap: refit in {stages2['fit']:.3f} s; v{version} live after chunk "
          f"{k_swap}/{n_chunks}; version stamps and composite alarms exact ({changed} chunk "
          "votes differ between the programs)")
    return rows, counts


def print_kernel_rows(rows: dict) -> None:
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"kernel {name}: {r['shape']}: max_abs_err {r['max_abs_err']:.3e} "
              f"(tol {r['tol']:.3e}{'; ' + r['note'] if 'note' in r else ''}); "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
        from repro_torch.serving import api
    except ImportError as exc:
        print(f"chip_smoke.py must run from a checkout of the repository: {exc}",
              file=sys.stderr)
        return 2

    # Phase 1: the card, and the kernel build.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"card: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    build.load()
    print(f"built {build.library_path().name} from {len(build._sources())} sources "
          f"in {time.perf_counter() - t0:.1f} s")
    for line in (build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    program = api.ScoringProgram.load(
        str(ROOT / "src/repro_torch/assets/seizure_program"), device="cuda"
    )
    print(f"program: proj {tuple(program.packed.proj.shape)}, cfg {program.cfg}")

    # Phase 2.
    rows = check_kernels(program, gen)

    # Phases 3-4 (cuSOLVER's first call initializes it: keep that out of
    # the timed engine runs).
    torch.linalg.eigh(torch.eye(8, device="cuda"))
    traffic = make_traffic(gen)
    launches = {"forest": 0, "wpd_level": 0, "gram": 0}
    for overlap in (0, 2):
        prog = api.ScoringProgram(program.packed, program.feat_mean, program.feat_std,
                                  program.cfg._replace(overlap=overlap))
        reset_counts()
        events, stats = drive(prog, traffic)
        counts = launch_counts()
        print(f"engine overlap={overlap}: steps {stats['steps']}, chunks scored "
              f"{stats['chunks']}, {stats['windows_per_s']:.1f} windows/s "
              f"({stats['seconds']:.2f} s), final alarms {stats['alarms']}, "
              f"launches {counts}")
        if stats["chunks"] != N_SESSIONS * CHUNKS_PER_SESSION:
            fail(f"scored {stats['chunks']} chunks, expected {N_SESSIONS * CHUNKS_PER_SESSION}")
        if min(counts[k] for k in launches) == 0:
            fail(f"a kernel of the path never launched: {counts}")
        for k in launches:
            launches[k] += counts[k]
        reset_counts()
        with plain_versions():
            plain_events, plain_stats = drive(prog, traffic)
        if any(launch_counts().values()):
            fail("a kernel launched during the plain run")
        differing = compare_events(events, plain_events, prog, traffic)
        print(f"engine overlap={overlap} plain path: {plain_stats['windows_per_s']:.1f} "
              f"windows/s; events equal, {differing} window predictions differ "
              "(all at routing margin < 1e-3)")

    for stage, ms in stage_times(program, traffic).items():
        print(f"stage {stage}: {ms:.3f} ms")
    trace_step(program, traffic)

    # Phase 6.
    hist_rows, fit_counts = training_phase(gen, program)
    rows.update(hist_rows)
    launches = {k: launches.get(k, 0) + fit_counts[k] for k in fit_counts}

    sources = {"forest": "forest.cu", "wpd_level": "wpd_level.cu", "gram": "gram.cu",
               "histogram": "histogram.cu"}
    replaces = {
        "forest": "src/repro/kernels/forest/kernel.py:73",
        "wpd_level": "src/repro/kernels/wpd/kernel.py:86",
        "gram": "src/repro/kernels/gram/kernel.py:66",
        "histogram": "src/repro/kernels/histogram/kernel.py:77",
    }
    main_rows = {"forest": "forest", "wpd_level": "wpd_level/2048", "gram": "gram/1024x180",
                 "histogram": f"histogram/{max(int(k.split('/')[1]) for k in hist_rows)}"}
    line = {"kernels": [
        {
            "name": k, "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources[k]}",
            "replaces": replaces[k], "launches": launches[k],
            "max_abs_err": rows[r]["max_abs_err"], "ms": rows[r]["ms"],
            "plain_ms": rows[r]["plain_ms"], "bound_ms": rows[r]["bound_ms"],
            "bound_by": rows[r]["bound_by"], "library_ms": rows[r]["library_ms"],
        }
        for k, r in main_rows.items()
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
