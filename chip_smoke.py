#!/usr/bin/env python3
"""Drive the PyTorch port of the seizure-scoring, training, dense LM
serving and hybrid LM serving paths on one CUDA card.

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
  7. LM serving at the full width of qwen3-0.6b (28 layers, 751.6 M
     parameters drawn from a seeded generator, bf16 compute). K5
     flash_attention against its plain version in the model's layout with
     GQA, as the kernel reads it in place (q (B, S, 16, hd), k and v (B, S,
     8, hd); the plain version expands the KV groups as ops.py does for a
     CPU tensor): the static prefill's launch (8, 2048) causal in bf16 and
     f32, a batch-1 admission's, a ragged S, a non-causal and an hd-64
     case, each held element by element within FLASH_TOL of its query
     row's scale and printed with its error, time, plain time, SDPA's time
     on the expanded (1, B*H, S, hd) tensors and bound. A static batch
     (``ServeEngine``, 8 slots, max_seq 4096, prompts of ragged length up
     to 2048, 32 new tokens each): K5 must launch exactly 28 times (once
     per layer of the one prefill); prefill ms, decode ms per step and
     tokens/s. Continuous batching (``ContinuousEngine``): 12 requests over
     4 slots with ragged max_new, prompts of 512 and 1024 tokens (batch-1
     prefills through K5) and of other lengths (plain ``_sdpa``); every
     request completes, admissions happen mid-stream, K5 launches 28 times
     per 512-multiple prompt. Both runs again with K5's plain version:
     the logits of every step whose context is the same on both paths
     (the prefills among them) within LM_LOGIT_TOL, tokens equal up to
     each request's first step whose plain-path top-2 margin is below
     LM_MARGIN. Profiler traces of one prefill and one decode step, with
     K5's share and the copies' beside it. The model is freed before
     phase 8.
  8. Hybrid LM serving at the full width and depth of zamba2-7b (81 Mamba2
     blocks behind 14 sites of one shared attention block, 6.75 B
     parameters drawn from a seeded generator, bf16 compute). K6
     ssd_chunks against its plain version on every case of SSD_CASES (the
     static prefill's (896, 8, 256, 64) with a nonzero h_in, a batch-1
     admission's, L = 77, L = 1, strong and weak decay, float32), each
     element within SSD_TOL of its row's scale, and ssd_scan end to end;
     each row printed with its error, time, plain time and bound. A static
     batch (8 slots, max_seq 4096, prompts of ragged length up to 2048,
     left-padded to 2048): K6 must launch exactly 162 times (twice per
     Mamba2 block of the one prefill) and K5 never (head_dim 112).
     Continuous batching: 10 requests over 4 slots, prompts of 256, 512
     and 77 tokens (K6 at L = 256 and 77, 162 launches each) and of
     300-1000 (scan_core's plain path), ragged max_new; every request
     completes, admissions happen mid-stream. Both runs again with K6's
     plain version: logits of every same-context step within
     HY_LOGIT_ULPS bf16 ulps of the largest |logit|, tokens equal up to
     each request's first plain margin below half of that. Profiler
     traces of one prefill and one decode step, with K6's share.
  9. A ``kernels`` JSON line (K1-K6), the script's seconds, the card line,
     and the last line ``{"ok": true, "device": {...}}``.
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
BF16_FLOP_PER_S = 989e12  # dense, tensor cores

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
# Phase 7: LM serving at the full width of qwen3-0.6b (random weights).
LM_ARCH = "qwen3-0.6b"
LM_SLOTS = 8
LM_MAX_SEQ = 4096
LM_MAX_NEW = 32
LM_STATIC_LENS = (2048, 1999, 1536, 1234, 1024, 777, 512, 301)  # padded width 2048
LM_CONT_SLOTS = 4
LM_CONT_MAX_SEQ = 2048
LM_CONT_LENS = (512, 1024, 700, 1500, 512, 333, 1024, 900, 512, 1100, 1024, 257)
LM_CONT_MAX_NEW = (8, 20, 12, 5, 16, 9, 24, 6, 11, 14, 7, 10)
# Kernel path against plain path, bf16 throughout: the two round P (and
# so each attention output) at different places, about one bf16 ulp
# apart, and 28 layers carry that into the logits, which are themselves
# bf16 products: at this random init the largest |logit| lies in [4, 8),
# where a bf16 ulp is 2^-5, and LM_LOGIT_TOL is 8 such ulps. A token can
# flip only where the plain path's top two logits lie closer than their two
# differences; those are a few ulps each, so tokens are compared up to the
# first step whose plain-path margin is below 4 ulps.
LM_LOGIT_TOL = 0.25   # max |logit difference| on the same context
LM_MARGIN = 0.125
# K5 against its plain version, element by element: |kernel - plain| <=
# REL |plain| + ROW max|plain row|, so each query row is held at its own
# scale (a row that averages i keys has outputs ~1/sqrt(i) of |v|). bf16:
# both round the output once (2^-7 covers one ulp between them); the plain
# version also rounds q.k to bf16 (about 2^-9 of |q.k|, ~0.01 of a unit
# logit) where the kernel keeps it f32, and the two round P at different
# places: together under 2^-6 of a row's largest output on random inputs.
# f32: one softmax in two orders of summation. tools/flash_faults.py plants
# faults in the kernel and reads how far over this limit each one lands.
FLASH_TOL = {"bfloat16": (2.0**-7, 2.0**-5), "float32": (2.0**-17, 2.0**-17)}
# Phase 8: hybrid serving at the full width of zamba2-7b (random weights).
HY_ARCH = "zamba2-7b"
HY_SLOTS = 8
HY_MAX_SEQ = 4096
HY_MAX_NEW = 24
HY_STATIC_LENS = (2048, 1999, 1536, 1234, 1024, 777, 512, 301)  # padded width 2048
HY_CONT_SLOTS = 4
HY_CONT_MAX_SEQ = 1024
# chunk = min(256, S): prompts of 256 and 512 reach K6 at L = 256, the one of
# 77 at L = 77; 300, 333, 700 and 1000 pass a chunk without being a multiple
# of it and take scan_core's plain path. Every prompt has at least
# ssm_conv - 1 = 3 tokens (models/ssm.py).
HY_CONT_LENS = (256, 512, 77, 300, 256, 700, 512, 333, 256, 1000)
HY_CONT_MAX_NEW = (8, 14, 6, 10, 12, 5, 9, 7, 11, 6)
# Kernel path against plain path, bf16 throughout. LM_LOGIT_TOL is 8 bf16
# ulps of the largest |logit| for 28 blocks whose attention outputs differ
# by about one ulp between the paths. zamba2-7b stacks 95 blocks (sqrt(95 /
# 28) ~ 1.8 times the spread), and the plain SSD rounds at more places than
# K6 does (the decay, q.k, the incoming state and its term, where K6 rounds
# P and y only), about twice K5's difference per block: 8 x 1.8 x 2 ~ 29,
# so the tolerance is HY_LOGIT_ULPS = 32 ulps of the largest |logit| this
# init gives (read from the static prefill), and tokens are compared up to
# each request's first plain-path top-2 margin below half of it, as LM_MARGIN
# is half of LM_LOGIT_TOL.
HY_LOGIT_ULPS = 32
# K6 against its plain version, element by element: |kernel - plain| <=
# REL |plain| + ROW max|plain row|, each row of y and of the state at its
# own scale. bf16: the kernel rounds P and y once each; the plain version
# also rounds the decay, q.k, their product, the intra-chunk sum, q exp(cum),
# h_in and the incoming-state term to bf16, each a 2^-9 relative error of
# terms whose sum is the row's scale: 2^-7 |plain| covers the outputs' last
# roundings, 2^-5 of the row's largest element the rest. float32: the same
# products, but cum is a float32 scan in another order than torch.cumsum;
# at |cum| up to ~2^8 its ulp is 2^-15, and a few ulps of cum move
# exp(cum_i - cum_j) by ~2^-14 relative: 2^-13 of each.
# tools/ssd_faults.py plants faults in K6 and reads how far over this limit
# each one lands.
SSD_TOL = {"bfloat16": (2.0**-7, 2.0**-5), "float32": (2.0**-13, 2.0**-13)}
# ssd_scan end to end: on top of the chunk step's roundings, the plain path
# rounds each chunk's pass-1 state to bf16 (its einsum's output type), where
# K6 keeps it float32, and pass 2 rounds that incoming state again: one more
# 2^-9 error in the term that is the scale of a chunk's first rows, so the
# row share doubles.
SSD_SCAN_TOL = (2.0**-7, 2.0**-4)
# K6 cases: (name, BH, NC, L, type, decay), q, k, v ~ N(0, 1), h_in ~ 16 N(0,
# 1) (a state summed over a chunk of unit k, v). Decays ld = -dt A: "model",
# dt = softplus(N(0, 1)) and A = exp(A_log), A_log ~ 0.02 N(0, 1), as the
# model's init draws them (cum near -200 at a chunk's end); "weak", Mamba2's
# published init (softplus(dt_bias) log-uniform in [1e-3, 0.1], A uniform in
# [1, 16]), so the incoming state still reaches the late rows; "strong", A =
# 8, cum below -1000 within the chunk.
SSD_CASES = (
    ("static prefill", 8 * 112, 8, 256, "bfloat16", "model"),
    ("batch-1 admission", 112, 2, 256, "bfloat16", "model"),
    ("ragged L", 112, 1, 77, "bfloat16", "model"),
    ("L = 1", 112, 1, 1, "bfloat16", "model"),
    ("strong decay", 112, 2, 256, "bfloat16", "strong"),
    ("weak decay", 8 * 112, 8, 256, "bfloat16", "weak"),
    ("float32", 112, 2, 256, "float32", "model"),
)


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


def bound_ms(n_bytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S
             ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_versions():
    """Route CUDA tensors to the plain versions for the duration (the
    wrappers' kernel entries are swapped for the ref functions)."""
    from repro_torch.kernels.flash_attention import kernel as ak, ops as ao
    from repro_torch.kernels.forest import kernel as fk, ref as fr
    from repro_torch.kernels.gram import kernel as gk, ref as gr
    from repro_torch.kernels.histogram import kernel as hk, ref as hr
    from repro_torch.kernels.ssd import kernel as sk, ref as sr
    from repro_torch.kernels.wpd import kernel as wk, ref as wr

    saved = (fk.forest_traverse, gk.gram, wk.wpd_level, hk.class_histogram, ak.flash_attention,
             sk.ssd_chunks)
    (fk.forest_traverse, gk.gram, wk.wpd_level, hk.class_histogram, ak.flash_attention,
     sk.ssd_chunks) = (fr.forest_traverse, gr.gram, wr.wpd_level, hr.class_histogram,
                       ao.reference, sr.ssd_chunks)
    try:
        yield
    finally:
        (fk.forest_traverse, gk.gram, wk.wpd_level, hk.class_histogram,
         ak.flash_attention, sk.ssd_chunks) = saved


def _kernel_modules() -> dict:
    from repro_torch.kernels.flash_attention import kernel as ak
    from repro_torch.kernels.forest import kernel as fk
    from repro_torch.kernels.gram import kernel as gk
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.wpd import kernel as wk

    return {"forest": fk, "wpd_level": wk, "gram": gk, "histogram": hk, "flash_attention": ak,
            "ssd_chunks": sk}


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


# ---------------------------------------------------------------------------
# Phase 7: LM serving (dense qwen3-0.6b, K5)
# ---------------------------------------------------------------------------

def flash_share(got, want) -> float:
    """The largest share of its FLASH_TOL tolerance that any element of
    K5's output ``got`` uses against the plain version's ``want`` (over 1:
    they disagree)."""
    rel, row = FLASH_TOL[str(want.dtype).split(".")[-1]]
    got, want = got.float(), want.float()
    tol = rel * want.abs() + row * want.abs().amax(-1, keepdim=True)
    return float(((got - want).abs() / tol).max())


def flash_row(gen, b: int, s: int, h: int, kv: int, hd: int, dtype, causal: bool) -> dict:
    """K5 against its plain version on random q (b, s, h, hd) and k, v (b,
    s, kv, hd) in the model's layout, element by element within FLASH_TOL;
    the plain version is ``ops.reference`` (the KV groups expanded and (B,
    H) flattened, as ops.py does for a CPU tensor). Timed beside
    F.scaled_dot_product_attention on the expanded (1, B*H, S, hd) tensors
    (a yardstick the port never calls) and its bound: q, k, v read and the
    output written once; causal work counts the S(S+1)/2 pairs a causal
    mask keeps, 4 hd flops each, at the type's peak rate."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as ak, ops as ao

    def randn(heads):
        return torch.randn((b, s, heads, hd), generator=gen, device=gen.device).to(dtype)

    q, k, v = randn(h), randn(kv), randn(kv)
    got, want = ak.flash_attention(q, k, v, causal=causal), ao.reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    bh = b * h
    qf, kf, vf = (t.repeat_interleave(h // t.shape[2], dim=2).transpose(1, 2)
                  .reshape(1, bh, s, hd).contiguous() for t in (q, k, v))
    err = float((got.float() - want.float()).abs().max())
    share = flash_share(got, want)
    rel, row = FLASH_TOL[str(dtype).split(".")[-1]]
    name = (f"flash_attention/{b}x{s}x{h}:{kv}x{hd} {str(dtype).split('.')[-1]} "
            f"{'causal' if causal else 'full'}")
    if not share <= 1.0:
        fail(f"{name} kernel disagrees with its plain version: an element uses {share} "
             f"of its tolerance {rel:.3g} |plain| + {row:.3g} max|plain row|")
    pairs = s * (s + 1) / 2 if causal else float(s * s)
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    b_ms, b_by = bound_ms((2 * q.numel() + 2 * k.numel()) * q.element_size(),
                          4.0 * hd * bh * pairs, rate)
    reps = dict(launches=5, reps=5) if dtype == torch.float32 else {}
    return dict(
        shape=f"q {tuple(q.shape)}, k, v {tuple(k.shape)}", max_abs_err=err, tol=None,
        note=f"tol per element {rel:.3g} |plain| + {row:.3g} max|plain row|, the worst "
             f"element uses {share:.4f} of it",
        ms=time_ms(lambda: ak.flash_attention(q, k, v, causal=causal), **reps),
        plain_ms=time_ms(lambda: ao.reference(q, k, v, causal=causal), **reps),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qf, kf, vf, is_causal=causal), **reps),
        bound_ms=b_ms, bound_by=b_by, name=name,
    )


def check_flash(gen) -> dict[str, dict]:
    import torch

    rows = {}
    # (B, S, H, KV, hd): qwen3-0.6b's 16 q heads over 8 KV heads of 128.
    for args in ((8, 2048, 16, 8, 128, torch.bfloat16, True),   # the static prefill's launch
                 (8, 2048, 16, 8, 128, torch.float32, True),
                 (1, 1024, 16, 8, 128, torch.bfloat16, True),    # a batch-1 admission prefill
                 (1, 1000, 16, 8, 128, torch.bfloat16, True),    # ragged S, masked in the kernel
                 (4, 1024, 16, 8, 128, torch.bfloat16, False),
                 (4, 1024, 16, 8, 64, torch.bfloat16, True)):
        r = flash_row(gen, *args)
        rows[r.pop("name")] = r
    print_kernel_rows(rows)
    return rows


@contextlib.contextmanager
def lm_recorder(model):
    """Record, for every prefill and decode step the engines run, the
    synchronized host time, the last-position logits and each row's
    argmax and top-2 margin (the model's methods are wrapped on the
    instance for the duration)."""
    import torch

    calls = {"prefill": [], "decode": []}

    def wrap(kind, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            last = logits[:, -1].float()
            top = last.topk(2, dim=-1).values
            calls[kind].append(dict(seconds=seconds, logits=last,
                                    tokens=last.argmax(-1).tolist(),
                                    margins=(top[:, 0] - top[:, 1]).tolist()))
            return logits, cache
        return run

    model.prefill = wrap("prefill", model.prefill)
    model.decode_step = wrap("decode", model.decode_step)
    try:
        yield calls
    finally:
        del model.prefill, model.decode_step


def lm_static(model, prompts, slots=LM_SLOTS, max_seq=LM_MAX_SEQ, max_new=LM_MAX_NEW):
    """ServeEngine over one static batch: the generated tokens, the
    recorded calls and the wall time of generate()."""
    import torch

    from repro_torch.serving.engine import ServeEngine

    engine = ServeEngine(model, max_batch=slots, max_seq=max_seq, eos_id=-1, device="cuda")
    with lm_recorder(model) as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = engine.generate(prompts, max_new=max_new)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return [o.tolist() for o in outs], calls, seconds


def continuous_schedule(max_new, slots):
    """With EOS never firing, the continuous engine's schedule depends on
    max_new alone: (per decode step, the request in each slot; the
    admissions as (decode step or -1 before the first, slot, request))."""
    queue = list(range(len(max_new)))
    occupant, count, admissions, steps = [None] * slots, {}, [], []
    for i in range(slots):
        if queue:
            r = queue.pop(0)
            occupant[i], count[r] = r, 1
            admissions.append((-1, i, r))
    while any(o is not None for o in occupant):
        steps.append(list(occupant))
        for i, r in enumerate(steps[-1]):
            if r is None:
                continue
            if count[r] >= max_new[r]:
                occupant[i] = None
                if queue:
                    r2 = queue.pop(0)
                    occupant[i], count[r2] = r2, 1
                    admissions.append((len(steps) - 1, i, r2))
            else:
                count[r] += 1
    return steps, admissions


def static_steps(calls, n, max_new=LM_MAX_NEW):
    """Each static request's steps as (token, top-2 margin, logits row):
    token t of request i is row i of call t (the prefill, then the decode
    steps; the last decode step's tokens are not kept)."""
    seq = calls["prefill"] + calls["decode"]
    return [[(c["tokens"][i], c["margins"][i], c["logits"][i]) for c in seq[:max_new]]
            for i in range(n)]


def continuous_steps(calls, steps, admissions, n, max_new=LM_CONT_MAX_NEW):
    """Each continuous request's steps as (token, top-2 margin, logits
    row), read along the schedule: its admission prefill, then each decode
    step that extended it."""
    out = [[] for _ in range(n)]
    for (_, _, r), call in zip(admissions, calls["prefill"]):
        out[r].append((call["tokens"][0], call["margins"][0], call["logits"][0]))
    for occupants, call in zip(steps, calls["decode"]):
        for i, r in enumerate(occupants):
            if r is not None and len(out[r]) < max_new[r]:
                out[r].append((call["tokens"][i], call["margins"][i], call["logits"][i]))
    return out


def lm_continuous(model, prompts, slots=LM_CONT_SLOTS, max_seq=LM_CONT_MAX_SEQ,
                  max_new=LM_CONT_MAX_NEW):
    import torch

    from repro_torch.serving.continuous import ContinuousEngine, Request

    engine = ContinuousEngine(model, max_batch=slots, max_seq=max_seq, eos_id=-1,
                              device="cuda")
    requests = [Request(p, m) for p, m in zip(prompts, max_new)]
    with lm_recorder(model) as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.serve(requests)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return requests, calls, seconds


def compare_paths(label, kernel, plain, tol=LM_LOGIT_TOL, margin=LM_MARGIN
                  ) -> tuple[float, int, int, int]:
    """kernel, plain: per request, per step (token, top-2 margin, logits
    row). (1) At every step whose context is the same on both paths (the
    request's earlier tokens equal), the logits agree within ``tol``.
    (2) Tokens are equal up to each request's first step whose plain-path
    margin is below ``margin``. Returns (max logit difference, steps whose
    logits were compared, steps whose tokens were compared, steps)."""
    diff, n_logits, n_tokens, total = 0.0, 0, 0, 0
    for r, (ks, ps) in enumerate(zip(kernel, plain)):
        total += len(ps)
        for t, ((kt, _, kl), (pt, _, pl)) in enumerate(zip(ks, ps)):
            d = float((kl - pl).abs().max())
            diff, n_logits = max(diff, d), n_logits + 1
            if not d <= tol:
                fail(f"{label}: request {r} step {t}: logits of the kernel and plain paths "
                     f"differ by {d} > {tol} on the same context")
            if kt != pt:
                break  # the contexts differ from the next step on
        stop = next((t for t, step in enumerate(ps) if step[1] < margin), len(ps))
        got, want = [step[0] for step in ks[:stop]], [step[0] for step in ps[:stop]]
        if got != want:
            fail(f"{label}: request {r} tokens differ before its first step with plain "
                 f"margin < {margin} (step {stop}): {got} vs {want}")
        n_tokens += stop
    return diff, n_logits, n_tokens, total


def lm_traces(model, tokens, max_seq=LM_MAX_SEQ, label="lm", ours=None) -> None:
    """Device busy and idle share, and device time by kernel, of one
    static prefill and of one decode step at the batch of ``tokens``; with
    ``ours`` (a substring of a kernel's name), that kernel's share of each
    trace's device time too, beside the time of the copies (memcpy
    activities and copy kernels)."""
    import torch

    _, cache = model.prefill({"tokens": tokens}, max_seq)
    step = {"tokens": torch.zeros((tokens.shape[0], 1), dtype=torch.int32, device="cuda")}
    for what, fn, name in (
        (f"one prefill {tuple(tokens.shape)}",
         lambda: model.prefill({"tokens": tokens}, max_seq), f"{label}_prefill_trace"),
        (f"one decode step ({tokens.shape[0]} slots, cache {max_seq})",
         lambda: model.decode_step(cache, step), f"{label}_decode_trace"),
    ):
        wall_ms, busy_ms, by_name = device_activity(fn, name)
        if busy_ms is None:
            print(f"{label} trace {what}: {wall_ms:.3f} ms wall; the profiler recorded no "
                  "device activity: busy and idle share not measured")
            continue
        print(f"{label} trace {what}: {wall_ms:.3f} ms wall (profiler on), device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
              f"{sum(n for _, n in by_name.values())} device activities")
        for kname, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"{label} trace kernel: {ms:.3f} ms in {n} launches: {kname[:110]}")
        if ours is not None:
            mine = [(ms, n) for kname, (ms, n) in by_name.items() if ours in kname]
            ms, n = sum(m for m, _ in mine), sum(c for _, c in mine)
            copies = [(ms, n) for kname, (ms, n) in by_name.items()
                      if "copy" in kname.lower() or "memcpy" in kname.lower()]
            c_ms, c_n = sum(m for m, _ in copies), sum(c for _, c in copies)
            print(f"{label} trace {what}: {ours} {ms:.3f} ms in {n} launches, "
                  f"{ms / busy_ms:.4f} of the device's busy time; copies {c_ms:.3f} ms in "
                  f"{c_n} activities, {c_ms / busy_ms:.4f}")


def lm_phase(gen) -> tuple[dict, int]:
    """Phase 7. Returns the K5 rows and K5's launches in the two engine
    runs through the kernels."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build

    rows = check_flash(gen)
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = build(cfg).init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    model.compute_params()
    torch.cuda.synchronize()
    print(f"lm model: {cfg.name}, {model.param_count() / 1e6:.1f} M parameters "
          f"(float32 master + bf16 compute copy), {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab {cfg.vocab_size}; "
          f"drawn in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    static_prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
                      for n in LM_STATIC_LENS]
    cont_prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
                    for n in LM_CONT_LENS]

    # Static batch through the kernels (after one warm-up generate).
    lm_static(model, static_prompts[:2])
    reset_counts()
    toks, calls, seconds = lm_static(model, static_prompts)
    k5_static = launch_counts()["flash_attention"]
    pre_s = calls["prefill"][0]["seconds"]
    dec = [c["seconds"] for c in calls["decode"]]
    n_tok = sum(len(t) for t in toks)
    print(f"lm static: {LM_SLOTS} slots, prompts {LM_STATIC_LENS} (padded width "
          f"{max(LM_STATIC_LENS)}), max_seq {LM_MAX_SEQ}, {LM_MAX_NEW} new tokens each: "
          f"prefill {pre_s * 1e3:.3f} ms, decode {statistics.median(dec) * 1e3:.3f} ms per step "
          f"(median of {len(dec)}), {n_tok} tokens in {seconds:.3f} s = {n_tok / seconds:.1f} "
          f"generated tokens/s ({LM_SLOTS / statistics.median(dec):.1f} tokens/s in decode); "
          f"K5 launches {k5_static}; largest |logit| of the prefill "
          f"{float(calls['prefill'][0]['logits'].abs().max()):.3f}")
    if k5_static != cfg.n_layers:
        fail(f"K5 launched {k5_static} times in the static run, expected {cfg.n_layers}")
    for row in calls["prefill"][0]["logits"], *(c["logits"] for c in calls["decode"]):
        if not bool(torch.isfinite(row).all()):
            fail("non-finite logits in the static run")
    reset_counts()
    with plain_versions():
        p_toks, p_calls, p_seconds = lm_static(model, static_prompts)
    if any(launch_counts().values()):
        fail("a kernel launched during the plain LM run")
    n = len(static_prompts)
    kernel, plain = static_steps(calls, n), static_steps(p_calls, n)
    if ([[st[0] for st in r] for r in kernel] != toks
            or [[st[0] for st in r] for r in plain] != p_toks):
        fail("static run: the recorded calls do not replay the generated tokens")
    diff, n_logits, n_tokens, total = compare_paths("lm static", kernel, plain)
    print(f"lm static plain path: prefill {p_calls['prefill'][0]['seconds'] * 1e3:.3f} ms, "
          f"{n_tok / p_seconds:.1f} generated tokens/s; logits on the same context differ by "
          f"at most {diff:.4e} (tol {LM_LOGIT_TOL}) over {n_logits} of {total} steps; tokens "
          f"equal on {n_tokens} of {total} steps (each request up to its first plain margin "
          f"< {LM_MARGIN})")
    del kernel, plain, calls, p_calls

    # Continuous batching: 12 requests over 4 slots.
    steps, admissions = continuous_schedule(LM_CONT_MAX_NEW, LM_CONT_SLOTS)
    reset_counts()
    reqs, calls, seconds = lm_continuous(model, cont_prompts)
    k5_cont = launch_counts()["flash_attention"]
    want_k5 = cfg.n_layers * sum(n % 512 == 0 for n in LM_CONT_LENS)
    mid = sum(step >= 0 for step, _, _ in admissions)
    if not all(r.done and len(r.out) == m for r, m in zip(reqs, LM_CONT_MAX_NEW)):
        fail(f"continuous run: not every request completed: {[len(r.out) for r in reqs]}")
    if k5_cont != want_k5 or len(calls["decode"]) != len(steps) or mid == 0:
        fail(f"continuous run: K5 {k5_cont} launches (expected {want_k5}), "
             f"{len(calls['decode'])} decode steps (schedule {len(steps)}), {mid} mid-stream "
             "admissions")
    kernel = continuous_steps(calls, steps, admissions, len(reqs))
    if [[st[0] for st in r] for r in kernel] != [r.out for r in reqs]:
        fail("continuous run: the recorded calls do not replay the requests' tokens")
    n_tok = sum(len(r.out) for r in reqs)
    print(f"lm continuous: {len(reqs)} requests over {LM_CONT_SLOTS} slots, prompts "
          f"{LM_CONT_LENS}, max_new {LM_CONT_MAX_NEW}: all complete; {len(steps)} decode "
          f"steps, {mid} admissions mid-stream; {n_tok} tokens in {seconds:.3f} s = "
          f"{n_tok / seconds:.1f} tokens/s; decode "
          f"{statistics.median(c['seconds'] for c in calls['decode']) * 1e3:.3f} ms per step "
          f"(median); K5 launches {k5_cont}")
    reset_counts()
    with plain_versions():
        p_reqs, p_calls, p_seconds = lm_continuous(model, cont_prompts)
    if any(launch_counts().values()):
        fail("a kernel launched during the plain continuous run")
    plain = continuous_steps(p_calls, steps, admissions, len(p_reqs))
    if [[st[0] for st in r] for r in plain] != [r.out for r in p_reqs]:
        fail("plain continuous run: the recorded calls do not replay the requests' tokens")
    diff, n_logits, n_tokens, total = compare_paths("lm continuous", kernel, plain)
    print(f"lm continuous plain path: {n_tok / p_seconds:.1f} tokens/s; logits on the same "
          f"context differ by at most {diff:.4e} (tol {LM_LOGIT_TOL}) over {n_logits} of "
          f"{total} steps; tokens equal on {n_tokens} of {total} steps (each request up to "
          f"its first plain margin < {LM_MARGIN})")
    del kernel, plain, calls, p_calls
    lm_traces(model, torch.from_numpy(np.stack([
        np.pad(p, (max(LM_STATIC_LENS) - len(p), 0)) for p in static_prompts])).to("cuda"),
        ours="flash_fwd")
    del model  # phase 8 needs the card's memory
    torch.cuda.empty_cache()
    return rows, k5_static + k5_cont


# ---------------------------------------------------------------------------
# Phase 8: hybrid serving (zamba2-7b, K6)
# ---------------------------------------------------------------------------

def ssd_log_decay(x, decay: str, gen):
    """ld = -dt A for x (BH, ...) ~ N(0, 1), with a per-row (head) A and dt
    bias drawn by the law ``decay`` names (see SSD_CASES)."""
    import math

    import torch
    import torch.nn.functional as F

    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    if decay == "weak":
        dt0 = torch.exp(torch.empty(shape, device=x.device).uniform_(
            math.log(1e-3), math.log(0.1), generator=gen))
        bias = dt0 + torch.log(-torch.expm1(-dt0))  # softplus(bias) = dt0
        a = torch.empty(shape, device=x.device).uniform_(1.0, 16.0, generator=gen)
        return -F.softplus(x + bias) * a
    if decay == "strong":
        return -F.softplus(x) * 8.0
    a_log = 0.02 * torch.randn(shape, generator=gen, device=x.device)
    return -F.softplus(x) * torch.exp(a_log)


def ssd_inputs(gen, bh: int, nc: int, l: int, dtype: str, decay: str):
    """q, k, v (bh, nc, l, 64), ld (bh, nc, l) of ``dtype``, h_in (bh, nc,
    64, 64) float32."""
    import torch

    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    q, k, v = (randn(bh, nc, l, 64).to(dt) for _ in range(3))
    ld = ssd_log_decay(randn(bh, nc, l), decay, gen).to(dt)
    return q, k, v, ld, 16.0 * randn(bh, nc, 64, 64)


def ssd_share(got, want, dtype: str, tol=None) -> float:
    """The largest share of its tolerance (SSD_TOL[dtype], or ``tol``) that
    any element of K6's output ``got`` (y or the state) uses against the
    plain version's ``want``, each row (last axis) at its own scale."""
    rel, row = SSD_TOL[dtype] if tol is None else tol
    got, want = got.float(), want.float()
    tol = rel * want.abs() + row * want.abs().amax(-1, keepdim=True)
    return float(((got - want).abs() / tol).max())


def ssd_bound(bh: int, nc: int, l: int, dtype: str) -> tuple[float, str]:
    """Least time for ssd_chunks on (bh, nc, l, 64): q, k, v, ld, h_in read
    and y, the state written once, against the causal q k^T and P v
    (64 L (L + 1) MACs per chunk, on the tensor cores in bf16) and q h_in
    plus the state (2 L 64^2 MACs, float32), each at its type's peak."""
    es = 2 if dtype == "bfloat16" else 4
    n = bh * nc
    n_bytes = n * (4 * l * 64 * es + l * es + 2 * 64 * 64 * 4)
    tc_flops = n * 2.0 * 64 * l * (l + 1)
    f32_flops = n * 4.0 * l * 64 * 64
    if dtype == "bfloat16":
        t_ops = max(tc_flops / BF16_FLOP_PER_S, f32_flops / FP32_FLOP_PER_S) * 1e3
    else:
        t_ops = (tc_flops + f32_flops) / FP32_FLOP_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssd_case_inputs(gen) -> list:
    """[(case, inputs, the plain version's (y, state))] for SSD_CASES."""
    from repro_torch.kernels.ssd import ref as sr

    out = []
    for case in SSD_CASES:
        inputs = ssd_inputs(gen, *case[1:])
        out.append((case, inputs, sr.ssd_chunks(*inputs)))
    return out


def ssd_shares(case, inputs, want) -> tuple[float, float, float]:
    """K6 on one case's inputs: (share of y, share of the state, max abs
    error of either)."""
    import torch

    from repro_torch.kernels.ssd import kernel as sk

    got = sk.ssd_chunks(*inputs)
    torch.cuda.synchronize()
    dtype = case[4]
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    return ssd_share(got[0], want[0], dtype), ssd_share(got[1], want[1], dtype), err


def check_ssd(gen) -> dict[str, dict]:
    """K6 against its plain version on every case of SSD_CASES, element by
    element within SSD_TOL, then ssd_scan end to end (y and the final
    state, two K6 launches around the inter-chunk loop) at the static
    prefill's (896, 2048, 64) against ssd_scan through the plain version,
    within SSD_SCAN_TOL; the row also gives each path's share of that
    tolerance against the plain scan of float32 copies of the inputs."""
    import torch

    from repro_torch.kernels.ssd import kernel as sk, ops as so, ref as sr

    rows = {}
    for case, inputs, want in ssd_case_inputs(gen):
        name, bh, nc, l, dtype, decay = case
        share_y, share_s, err = ssd_shares(case, inputs, want)
        rel, row = SSD_TOL[dtype]
        label = f"ssd_chunks/{name} ({bh}, {nc}, {l}, 64) {dtype} {decay} decay"
        if not max(share_y, share_s) <= 1.0:
            fail(f"{label}: K6 disagrees with its plain version: an element of y uses "
                 f"{share_y}, of the state {share_s}, of its tolerance {rel:.3g} |plain| + "
                 f"{row:.3g} max|plain row|")
        cum_min = float(torch.cumsum(inputs[3].float(), -1).min())
        if decay == "strong" and not cum_min < -1000:
            fail(f"{label}: cum reaches only {cum_min}, not below -1000")
        b_ms, b_by = ssd_bound(bh, nc, l, dtype)
        reps = {} if bh * nc <= 1024 else dict(launches=5, reps=5)
        rows[label] = dict(
            shape=f"q, k, v ({bh}, {nc}, {l}, 64), h_in nonzero, min cum {cum_min:.1f}",
            max_abs_err=err, tol=None,
            note=f"tol per element {rel:.3g} |plain| + {row:.3g} max|plain row|, the worst "
                 f"element of y uses {share_y:.4f} of it, of the state {share_s:.4f}",
            ms=time_ms(lambda: sk.ssd_chunks(*inputs)),
            plain_ms=time_ms(lambda: sr.ssd_chunks(*inputs), **reps),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
        )
    for decay in ("model", "weak"):
        q, k, v, ld, _ = ssd_inputs(gen, 8 * 112, 1, 2048, "bfloat16", decay)
        args = (q[:, 0], k[:, 0], v[:, 0], ld[:, 0])
        got = so.ssd_scan(*args)
        with plain_versions():
            want = so.ssd_scan(*args)
            plain_ms = time_ms(lambda: so.ssd_scan(*args), launches=5, reps=5)
            exact = so.ssd_scan(*(t.float() for t in args))
        share_y = ssd_share(got[0], want[0], "bfloat16", SSD_SCAN_TOL)
        share_s = ssd_share(got[1], want[1], "bfloat16", SSD_SCAN_TOL)
        vs_f32 = {path: max(ssd_share(r[0], exact[0], "bfloat16", SSD_SCAN_TOL),
                            ssd_share(r[1], exact[1], "bfloat16", SSD_SCAN_TOL))
                  for path, r in (("kernel", got), ("plain", want))}
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        label = f"ssd_scan/static prefill (896, 2048, 64) bfloat16 {decay} decay"
        rel, row = SSD_SCAN_TOL
        if not max(share_y, share_s) <= 1.0:
            fail(f"{label}: ssd_scan through K6 disagrees with its plain version: y uses "
                 f"{share_y}, the final state {share_s}, of its tolerance")
        b_ms, b_by = ssd_bound(8 * 112, 8, 256, "bfloat16")
        rows[label] = dict(
            shape="two K6 launches at (896, 8, 256, 64) and the chunk loop",
            max_abs_err=err, tol=None,
            note=f"tol per element {rel:.3g} |plain| + {row:.3g} max|plain row|, the worst "
                 f"element of y uses {share_y:.4f} of it, of the final state {share_s:.4f}; "
                 f"against the float32 scan the kernel path uses {vs_f32['kernel']:.4f}, the "
                 f"plain path {vs_f32['plain']:.4f}; bound: the two launches'",
            ms=time_ms(lambda: so.ssd_scan(*args), launches=5, reps=5),
            plain_ms=plain_ms, library_ms=None, bound_ms=2 * b_ms, bound_by=b_by,
        )
        del q, k, v, ld, args, got, want, exact
    print_kernel_rows(rows)
    torch.cuda.empty_cache()
    return rows


def hybrid_phase(gen) -> tuple[dict, int]:
    """Phase 8. Returns the K6 rows and K6's launches in the two engine
    runs through the kernels."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build

    rows = check_ssd(gen)
    cfg = get_config(HY_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg).init(torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    model.compute_params()
    torch.cuda.synchronize()
    n_full, rem, per = model._hybrid_shape()
    print(f"hybrid model: {cfg.name}, {model.param_count():,} parameters (float32 master + "
          f"bf16 compute copy, {torch.cuda.memory_allocated() / 1e9:.2f} GB), {cfg.n_layers} "
          f"Mamba2 blocks in {n_full} groups of {per} + {rem} behind {model.n_attn_sites} "
          f"sites of one shared attention block, d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, {cfg.n_ssm_heads} SSM heads of "
          f"{cfg.ssm_head_dim} x state {cfg.ssm_state}, vocab {cfg.vocab_size}; drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    static_prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
                      for n in HY_STATIC_LENS]
    cont_prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
                    for n in HY_CONT_LENS]
    static = dict(slots=HY_SLOTS, max_seq=HY_MAX_SEQ)
    cont = dict(slots=HY_CONT_SLOTS, max_seq=HY_CONT_MAX_SEQ, max_new=HY_CONT_MAX_NEW)

    # Static batch through the kernels (after one short warm-up generate).
    lm_static(model, static_prompts[:2], max_new=2, **static)
    reset_counts()
    toks, calls, seconds = lm_static(model, static_prompts, max_new=HY_MAX_NEW, **static)
    counts = launch_counts()
    k6_static = counts["ssd_chunks"]
    pre_s = calls["prefill"][0]["seconds"]
    dec = [c["seconds"] for c in calls["decode"]]
    n_tok = sum(len(t) for t in toks)
    max_logit = float(calls["prefill"][0]["logits"].abs().max())
    tol = HY_LOGIT_ULPS * 2.0 ** (math.floor(math.log2(max_logit)) - 7)
    margin = tol / 2
    print(f"hybrid static: {HY_SLOTS} slots, prompts {HY_STATIC_LENS} (padded width "
          f"{max(HY_STATIC_LENS)}), max_seq {HY_MAX_SEQ}, {HY_MAX_NEW} new tokens each: "
          f"prefill {pre_s * 1e3:.3f} ms, decode {statistics.median(dec) * 1e3:.3f} ms per "
          f"step (median of {len(dec)}), {n_tok} tokens in {seconds:.3f} s = "
          f"{n_tok / seconds:.1f} generated tokens/s ({HY_SLOTS / statistics.median(dec):.1f} "
          f"tokens/s in decode); K6 launches {k6_static}, K5 {counts['flash_attention']}; "
          f"largest |logit| of the prefill {max_logit:.3f}, so the logit tolerance is "
          f"{tol} ({HY_LOGIT_ULPS} bf16 ulps) and the token margin {margin}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if k6_static != 2 * cfg.n_layers:
        fail(f"K6 launched {k6_static} times in the static run, expected {2 * cfg.n_layers}")
    if counts["flash_attention"]:
        fail("K5 launched in the hybrid run (head_dim 112 keeps its gate shut)")
    for row in calls["prefill"][0]["logits"], *(c["logits"] for c in calls["decode"]):
        if not bool(torch.isfinite(row).all()):
            fail("non-finite logits in the hybrid static run")
    reset_counts()
    with plain_versions():
        p_toks, p_calls, p_seconds = lm_static(model, static_prompts, max_new=HY_MAX_NEW,
                                               **static)
    if any(launch_counts().values()):
        fail("a kernel launched during the plain hybrid run")
    n = len(static_prompts)
    kernel = static_steps(calls, n, HY_MAX_NEW)
    plain = static_steps(p_calls, n, HY_MAX_NEW)
    if ([[st[0] for st in r] for r in kernel] != toks
            or [[st[0] for st in r] for r in plain] != p_toks):
        fail("hybrid static run: the recorded calls do not replay the generated tokens")
    diff, n_logits, n_tokens, total = compare_paths("hybrid static", kernel, plain, tol, margin)
    print(f"hybrid static plain path: prefill {p_calls['prefill'][0]['seconds'] * 1e3:.3f} ms, "
          f"{n_tok / p_seconds:.1f} generated tokens/s; logits on the same context differ by "
          f"at most {diff:.4e} (tol {tol}) over {n_logits} of {total} steps; tokens equal on "
          f"{n_tokens} of {total} steps (each request up to its first plain margin < {margin})")
    del kernel, plain, calls, p_calls

    # Continuous batching over 4 slots.
    steps, admissions = continuous_schedule(HY_CONT_MAX_NEW, HY_CONT_SLOTS)
    reset_counts()
    reqs, calls, seconds = lm_continuous(model, cont_prompts, **cont)
    k6_cont = launch_counts()["ssd_chunks"]
    gated = sum(n <= cfg.ssm_chunk or n % cfg.ssm_chunk == 0 for n in HY_CONT_LENS)
    want_k6 = 2 * cfg.n_layers * gated
    mid = sum(step >= 0 for step, _, _ in admissions)
    if not all(r.done and len(r.out) == m for r, m in zip(reqs, HY_CONT_MAX_NEW)):
        fail(f"hybrid continuous run: not every request completed: {[len(r.out) for r in reqs]}")
    if k6_cont != want_k6 or len(calls["decode"]) != len(steps) or mid == 0:
        fail(f"hybrid continuous run: K6 {k6_cont} launches (expected {want_k6}), "
             f"{len(calls['decode'])} decode steps (schedule {len(steps)}), {mid} mid-stream "
             "admissions")
    kernel = continuous_steps(calls, steps, admissions, len(reqs), HY_CONT_MAX_NEW)
    if [[st[0] for st in r] for r in kernel] != [r.out for r in reqs]:
        fail("hybrid continuous run: the recorded calls do not replay the requests' tokens")
    n_tok = sum(len(r.out) for r in reqs)
    print(f"hybrid continuous: {len(reqs)} requests over {HY_CONT_SLOTS} slots, prompts "
          f"{HY_CONT_LENS}, max_new {HY_CONT_MAX_NEW}: all complete; {len(steps)} decode "
          f"steps, {mid} admissions mid-stream; {n_tok} tokens in {seconds:.3f} s = "
          f"{n_tok / seconds:.1f} tokens/s; decode "
          f"{statistics.median(c['seconds'] for c in calls['decode']) * 1e3:.3f} ms per step "
          f"(median); K6 launches {k6_cont} ({gated} prompts through K6, {2 * cfg.n_layers} "
          "each)")
    reset_counts()
    with plain_versions():
        p_reqs, p_calls, p_seconds = lm_continuous(model, cont_prompts, **cont)
    if any(launch_counts().values()):
        fail("a kernel launched during the plain hybrid continuous run")
    plain = continuous_steps(p_calls, steps, admissions, len(p_reqs), HY_CONT_MAX_NEW)
    if [[st[0] for st in r] for r in plain] != [r.out for r in p_reqs]:
        fail("plain hybrid continuous run: the recorded calls do not replay the tokens")
    diff, n_logits, n_tokens, total = compare_paths("hybrid continuous", kernel, plain, tol,
                                                    margin)
    print(f"hybrid continuous plain path: {n_tok / p_seconds:.1f} tokens/s; logits on the "
          f"same context differ by at most {diff:.4e} (tol {tol}) over {n_logits} of {total} "
          f"steps; tokens equal on {n_tokens} of {total} steps (each request up to its first "
          f"plain margin < {margin})")
    del kernel, plain, calls, p_calls
    lm_traces(model, torch.from_numpy(np.stack([
        np.pad(p, (max(HY_STATIC_LENS) - len(p), 0)) for p in static_prompts])).to("cuda"),
        HY_MAX_SEQ, "hybrid", "ssd_chunk")
    print(f"hybrid peak memory: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated "
          f"at most in the phase")
    del model
    torch.cuda.empty_cache()
    return rows, k6_static + k6_cont


def print_kernel_rows(rows: dict) -> None:
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        tol = [] if r["tol"] is None else [f"tol {r['tol']:.3e}"]
        print(f"kernel {name}: {r['shape']}: max_abs_err {r['max_abs_err']:.3e} "
              f"({'; '.join(tol + ([r['note']] if 'note' in r else []))}); "
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
    t_start = time.perf_counter()
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

    # Phase 7.
    flash_rows, launches["flash_attention"] = lm_phase(gen)
    rows.update(flash_rows)

    # Phase 8.
    ssd_rows, launches["ssd_chunks"] = hybrid_phase(gen)
    rows.update(ssd_rows)

    sources = {"forest": "forest.cu", "wpd_level": "wpd_level.cu", "gram": "gram.cu",
               "histogram": "histogram.cu", "flash_attention": "flash_attention.cu",
               "ssd_chunks": "ssd_chunks.cu"}
    replaces = {
        "forest": "src/repro/kernels/forest/kernel.py:73",
        "wpd_level": "src/repro/kernels/wpd/kernel.py:86",
        "gram": "src/repro/kernels/gram/kernel.py:66",
        "histogram": "src/repro/kernels/histogram/kernel.py:77",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:103",
        "ssd_chunks": "src/repro/kernels/ssd/kernel.py:74",
    }
    main_rows = {"forest": "forest", "wpd_level": "wpd_level/2048", "gram": "gram/1024x180",
                 "histogram": f"histogram/{max(int(k.split('/')[1]) for k in hist_rows)}",
                 "flash_attention": next(iter(flash_rows)), "ssd_chunks": next(iter(ssd_rows))}
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
    print(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
