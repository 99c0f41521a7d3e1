#!/usr/bin/env python3
"""Drive the PyTorch port of the seizure-scoring path on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. Device: the card's name and power limit from nvidia-smi; the kernel
     library is built from ``src/repro_torch/csrc`` (nvcc, first use).
  2. Kernels: K1 forest, K2 wpd_level and K3 gram against their plain
     PyTorch versions at the main path's shapes, each with its error,
     its time, the plain version's time, one PyTorch library call's time
     where one computes the same function, and its bound on this card.
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
     share, device time by kernel), a ``kernels`` JSON line, the card
     line, and the last line ``{"ok": true, "device": {...}}``.
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
    from repro_torch.kernels.wpd import kernel as wk, ref as wr

    saved = (fk.forest_traverse, gk.gram, wk.wpd_level)
    fk.forest_traverse, gk.gram, wk.wpd_level = (
        fr.forest_traverse, gr.gram, wr.wpd_level
    )
    try:
        yield
    finally:
        fk.forest_traverse, gk.gram, wk.wpd_level = saved


def launch_counts() -> dict[str, int]:
    from repro_torch.kernels.forest import kernel as fk
    from repro_torch.kernels.gram import kernel as gk
    from repro_torch.kernels.wpd import kernel as wk

    return {"forest": fk.LAUNCHES, "wpd_level": wk.LAUNCHES, "gram": gk.LAUNCHES}


def reset_counts() -> None:
    from repro_torch.kernels.forest import kernel as fk
    from repro_torch.kernels.gram import kernel as gk
    from repro_torch.kernels.wpd import kernel as wk

    fk.LAUNCHES = gk.LAUNCHES = wk.LAUNCHES = 0


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


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(program, gen) -> dict[str, dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.forest import kernel as fk, ref as fr
    from repro_torch.kernels.gram import kernel as gk, ref as gr
    from repro_torch.kernels.wpd import kernel as wk, ref as wr
    from repro_torch.signal import wavelet

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
    h, g = wavelet.filters("db4")
    weight = torch.stack([h, g])[:, None, :].to(dev)  # (2, 1, taps)
    taps = h.shape[0]
    for n in (2048, 1024):
        xr = torch.randn((MAX_BATCH * REPLAY_DEPTH * 60 * 3, n), generator=gen, device=dev)
        (ka, kd), (pa, pd) = wk.wpd_level(xr, h, g), wr.wpd_level(xr, h, g)
        torch.cuda.synchronize()
        err = max(float((ka - pa).abs().max()), float((kd - pd).abs().max()))
        tol = 1e-5 * float(xr.abs().max())

        def conv(xr=xr):
            return F.conv1d(F.pad(xr[:, None, :], (0, taps - 2), mode="circular"),
                            weight, stride=2)

        b_ms, b_by = bound_ms(4 * 2 * xr.numel(), 2.0 * taps * xr.numel())
        rows[f"wpd_level/{n}"] = dict(
            shape=f"x {tuple(xr.shape)}", max_abs_err=err, tol=tol,
            ms=time_ms(lambda: wk.wpd_level(xr, h, g)),
            plain_ms=time_ms(lambda: wr.wpd_level(xr, h, g)),
            library_ms=time_ms(conv), bound_ms=b_ms, bound_by=b_by,
        )
        if not err <= tol:
            fail(f"wpd_level kernel (N={n}) disagrees with its plain version: {err} > {tol}")

    # K3: MSPCA's finest and coarsest per-scale covariances of one step,
    # passed as the transposed view pca.fit_T hands over.
    for n, p in ((1024, 180), (64, 186)):
        xt = torch.randn((MAX_BATCH * REPLAY_DEPTH, p, n), generator=gen, device=dev)
        xv = xt.transpose(1, 2)
        got, want = gk.gram(xv), gr.gram(xv)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-5 * float(want.abs().max())
        # G is symmetric: p (p + 1) / 2 sums of n products per matrix.
        b_ms, b_by = bound_ms(4 * (xt.numel() + xt.shape[0] * p * p),
                              1.0 * xt.shape[0] * n * p * (p + 1))
        rows[f"gram/{n}x{p}"] = dict(
            shape=f"x {tuple(xv.shape)} (transposed view)", max_abs_err=err, tol=tol,
            ms=time_ms(lambda: gk.gram(xv)),
            plain_ms=time_ms(lambda: gr.gram(xv)),
            library_ms=time_ms(lambda: torch.matmul(xv.transpose(1, 2), xv)),
            bound_ms=b_ms, bound_by=b_by,
        )
        if not err <= tol:
            fail(f"gram kernel ({n}x{p}) disagrees with its plain version: {err} > {tol}")

    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"kernel {name}: {r['shape']}: max_abs_err {r['max_abs_err']:.3e} "
              f"(tol {r['tol']:.3e}{'; ' + r['note'] if 'note' in r else ''}); "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
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
        if min(counts.values()) == 0:
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

    sources = {"forest": "forest.cu", "wpd_level": "wpd_level.cu", "gram": "gram.cu"}
    replaces = {
        "forest": "src/repro/kernels/forest/kernel.py:73",
        "wpd_level": "src/repro/kernels/wpd/kernel.py:86",
        "gram": "src/repro/kernels/gram/kernel.py:66",
    }
    main_rows = {"forest": "forest", "wpd_level": "wpd_level/2048", "gram": "gram/1024x180"}
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
