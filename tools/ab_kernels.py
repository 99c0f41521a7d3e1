#!/usr/bin/env python3
"""Time kernels and one static prefill in the port of a given checkout, so
that two checkouts can be compared in one call on one card.

Run from the root of a checkout, on one CUDA card:

    python3 tools/ab_kernels.py                      # this checkout
    python3 tools/ab_kernels.py --root path/to/other/checkout
    python3 tools/ab_kernels.py --hybrid [--root ...]
    python3 tools/ab_kernels.py --scoring [--root ...]
    python3 tools/ab_kernels.py --gate 0,1,2,3 [--root ...]
    python3 tools/ab_kernels.py --grower [--root ...]

The other checkout's ``src/repro_torch`` is imported (and its kernels
built) in place of this one's; run the two in turns in separate processes
(A, B, B, A) and compare within the call. Each line starts with the label
(--label, default the root's name).

Default (the dense LM and scoring kernels):

- K5 through ``ops.flash_attention`` at the static prefill's launch, q (8,
  2048, 16, 128) and k, v (8, 2048, 8, 128) bf16 causal in the model's
  layout: the route as attn_apply calls it (a port whose kernel takes
  (B*H, S, hd) expands and copies around the launch), and the kernel
  launch alone;
- K3 at the scoring path's (32, 1024, 180) and (32, 64, 186) and a fit's
  (1, 1024, 180), each a transposed view as pca.fit_T hands it over;
- one static prefill (8, 2048) of qwen3-0.6b.

With --hybrid (K6 and the hybrid LM):

- K6 ``ssd_chunks`` (the full function) at (896, 8, 256, 64) bf16, and,
  where the port has them, its states and outputs modes at the static
  prefill's grouped shape (8 batch rows, 8 chunks of 256, 112 heads of 64);
- one static prefill (8, 2048) of zamba2-7b.

With --scoring (K1, K2 and the seizure paths they serve):

- K1 at an engine step's x (1920, 288) on the committed program, through
  ``ops.forest_predict_proba`` (as the engine calls it) and the kernel
  launch alone;
- K2 at an engine step's (5760, 2048): one level, and the step's packet
  tree (level 4) and DWT (level 5) through ``signal.wavelet`` (the route the
  main path takes: one launch each where the port has the one-launch
  entries, else the chained single level with its stacks), each also at a
  fit's (180, 2048);
- ``features.wpd_features`` of one step (32 chunks of generated EEG; CUDA
  events), ``mspca.denoise_windows`` of the same chunks and one engine step
  (each the median of 5, synchronized wall), and the default MapReduce fit
  over 2 shards of 16 + 16 chunks (median of 3), with K1's and K2's
  launches in each.

With --grower (K4 and the tree grower it serves): the default MapReduce fit
over 2 shards of 16 + 16 chunks, once, with the grower's calls captured;
then, on the last shard's own inputs, ``hist_ops.level_histogram`` at each
of the six levels as the grower calls it (whatever bucket-id arithmetic the
port does around its launch included; CUDA events, and the device time of
the K4 kernel from a profile) and one ``fit_forest_binned`` call on (5, 960,
288) (CUDA events around 3 calls, median of 5), with K4's launches.

With --gate SEEDS, chip_smoke.py's training accuracy gate (the port-trained
forest against the committed program on a held-out timeline, at most 0.05
behind) on each seed's own draw of the training set and the timeline.

A prefill line gives the median wall ms of 3 (synchronized; random bf16
weights from --seed), then one profile: device busy ms, the kernel's ms and
launches (K5: names with "flash_fwd"; K6: "ssd_chunk"), and the copies'
(memcpy activities and kernels named *copy*, the filter chip_smoke.py's
trace lines use).

Times are CUDA events around 20 back-to-back calls, median of 7 groups.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path


def time_ms(fn, launches: int = 20, reps: int = 7, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def prefill_report(label: str, arch: str, seed: int, ours: str, max_seq: int = 4096,
                   b: int = 8, s: int = 2048) -> None:
    """One static prefill (b, s) of ``arch``: wall time and one profile."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import build as build_model

    cfg = get_config(arch)
    model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(seed),
                                  device="cuda")
    model.compute_params()
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        2, cfg.vocab_size, size=(b, s)).astype(np.int32)).to("cuda")

    def prefill():
        return model.prefill({"tokens": tokens}, max_seq)

    prefill()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill()
        torch.cuda.synchronize()
    device = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    busy, end, mine, copies = 0.0, float("-inf"), [0.0, 0], [0.0, 0]
    for e in device:
        busy += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
        ms = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        for acc, hit in ((mine, ours in name), (copies, "copy" in name)):
            if hit:
                acc[0] += ms
                acc[1] += 1
    print(f"{label}: {arch} static prefill ({b}, {s}): {statistics.median(walls):.3f} ms "
          f"(median of 3, synchronized); profiled: device busy {busy / 1e3:.3f} ms, {ours} "
          f"{mine[0]:.3f} ms in {mine[1]} launches, copies {copies[0]:.3f} ms in {copies[1]} "
          "activities", flush=True)


def dense(label: str, seed: int) -> None:
    import torch

    from repro_torch.kernels.flash_attention import kernel as ak, ops as ao
    from repro_torch.kernels.gram import kernel as gk

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, s, h, kv, hd = 8, 2048, 16, 8, 128
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device="cuda").to(torch.bfloat16)
               for n in (h, kv, kv))
    if hasattr(ak, "tensor_maps"):  # the kernel reads the model layout in place
        def launch():
            return ak.flash_attention(q, k, v, causal=True)
    else:  # the kernel takes (B*H, S, hd)
        qf, kf, vf = (t.repeat_interleave(h // t.shape[2], dim=2).transpose(1, 2)
                      .reshape(b * h, s, hd).contiguous() for t in (q, k, v))

        def launch():
            return ak.flash_attention(qf, kf, vf, causal=True)
    print(f"{label}: K5 q {tuple(q.shape)} k, v {tuple(k.shape)} bf16 causal: route "
          f"(ops.flash_attention) {time_ms(lambda: ao.flash_attention(q, k, v, causal=True)):.4f}"
          f" ms, kernel launch {time_ms(launch):.4f} ms")
    for batch, n, p in ((32, 1024, 180), (32, 64, 186), (1, 1024, 180)):
        x = torch.randn((batch, p, n), generator=gen, device="cuda").transpose(1, 2)
        print(f"{label}: K3 x {tuple(x.shape)} (transposed view): "
              f"{time_ms(lambda: gk.gram(x)):.4f} ms")
    prefill_report(label, "qwen3-0.6b", seed, "flash_fwd")


def hybrid(label: str, seed: int) -> None:
    import torch

    from repro_torch.kernels.ssd import kernel as sk

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, k, v = (randn(896, 8, 256, 64).to(torch.bfloat16) for _ in range(3))
    ld = (-torch.nn.functional.softplus(randn(896, 8, 256))).to(torch.bfloat16)
    h_in = 16.0 * randn(896, 8, 64, 64)
    print(f"{label}: K6 ssd_chunks (896, 8, 256, 64) bf16: "
          f"{time_ms(lambda: sk.ssd_chunks(q, k, v, ld, h_in), launches=5, reps=5):.4f} ms",
          flush=True)
    del q, k, v, ld, h_in
    if hasattr(sk, "ssd_chunk_states"):
        g, nc, n_l, hg = 8, 8, 256, 112
        qk = randn(g, nc, n_l, 128).to(torch.bfloat16)
        q, k = qk[..., :64], qk[..., 64:]
        v = randn(g, nc, n_l, hg, 64).to(torch.bfloat16)
        ld = (-torch.nn.functional.softplus(randn(g, nc, n_l, hg))).to(torch.bfloat16)
        h_in = 16.0 * randn(g, hg, nc, 64, 64)
        print(f"{label}: K6 grouped ({g}, {nc}, {n_l}, {hg}, 64) bf16: states "
              f"{time_ms(lambda: sk.ssd_chunk_states(k, v, ld)):.4f} ms, outputs "
              f"{time_ms(lambda: sk.ssd_chunk_outputs(q, k, v, ld, h_in)):.4f} ms", flush=True)
        del qk, q, k, v, ld, h_in
    torch.cuda.empty_cache()
    prefill_report(label, "zamba2-7b", seed, "ssd_chunk")


def scoring(label: str, seed: int, root: Path) -> None:
    import torch

    from repro_torch.kernels.forest import kernel as fk, ops as fo
    from repro_torch.kernels.wpd import kernel as wk
    from repro_torch.serving import api
    from repro_torch.signal import eeg_data, features, mspca, pipeline, wavelet

    gen = torch.Generator(device="cuda").manual_seed(seed)
    program = api.ScoringProgram.load(str(root / "src/repro_torch/assets/seizure_program"),
                                      device="cuda").to("cuda")
    packed = program.packed
    x = torch.randn((1920, packed.proj.shape[1]), generator=gen, device="cuda")
    # A port whose K1 walks derived tables takes them in place of proj.
    args = ((x, packed.proj_nodes, packed.thr, packed.next_node, packed.leaf_probs)
            if hasattr(packed, "next_node") else (x, packed.proj, packed.thr, packed.leaf_probs))
    print(f"{label}: K1 x {tuple(x.shape)}: route (forest_predict_proba) "
          f"{time_ms(lambda: fo.forest_predict_proba(packed, x)):.4f} ms, kernel launch "
          f"{time_ms(lambda: fk.forest_traverse(*args)):.4f} ms", flush=True)
    h, g = wavelet.filters("db4")
    for rows in (5760, 180):
        xr = torch.randn((rows, 2048), generator=gen, device="cuda")
        print(f"{label}: K2 x ({rows}, 2048): one level {time_ms(lambda: wk.wpd_level(xr, h, g)):.4f}"
              f" ms, packet tree L4 (wavelet.wpd) {time_ms(lambda: wavelet.wpd(xr, 4)):.4f} ms, "
              f"DWT L5 (wavelet.dwt) {time_ms(lambda: wavelet.dwt(xr, 5)):.4f} ms", flush=True)

    b, d, per = 8, 4, eeg_data.WINDOWS_PER_MATRIX
    windows = eeg_data.generate_windows(gen, 3, eeg_data.INTERICTAL, b * d * per)
    chunks = windows.reshape(b, d, per, *windows.shape[1:]).to("cuda")
    flat = chunks.reshape(-1, *chunks.shape[2:])
    state = api.init_state(b, program.cfg.alarm_m, device="cuda")
    active = torch.ones((b, d), dtype=torch.int32, device="cuda")

    def step():
        return api._engine_step_megabatch(state, chunks, active, packed, program.feat_mean,
                                          program.feat_std, cfg=program.cfg)

    def launches(fn):
        fk.LAUNCHES = wk.LAUNCHES = 0
        fn()
        torch.cuda.synchronize()
        return f"K1 {fk.LAUNCHES}, K2 {wk.LAUNCHES}"

    def wall_ms(fn, reps):
        fn()
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    torch.linalg.eigh(torch.eye(8, device="cuda"))  # cuSOLVER's first call, outside the clock
    for what, fn, how in (
        (f"features.wpd_features ({flat.shape[0]} chunks)", lambda: features.wpd_features(flat),
         "CUDA events, 5 calls, median of 5"),
        (f"mspca.denoise_windows ({flat.shape[0]} chunks)", lambda: mspca.denoise_windows(flat),
         "wall, median of 5"),
        (f"engine step ({b} x {d} chunks)", step, "wall, median of 5"),
    ):
        ms = time_ms(fn, launches=5, reps=5) if how.startswith("CUDA") else wall_ms(fn, 5)
        print(f"{label}: {what}: {ms:.3f} ms ({how}); launches {launches(fn)}", flush=True)

    cfg = pipeline.PipelineConfig()
    rec = eeg_data.stratify_chunks(eeg_data.make_training_set(
        gen, 3, n_interictal_windows=16 * per, n_preictal_windows=16 * per))

    def fit():
        return pipeline.fit(gen, rec, cfg, n_shards=2)

    print(f"{label}: default fit (2 shards of {rec.windows.shape[0] // 2} windows): "
          f"{wall_ms(fit, 3) / 1e3:.3f} s (median of 3); launches {launches(fit)}", flush=True)


def device_ms(fn, kernel: str, calls: int = 20) -> float | None:
    """Device time of one ``fn()`` in the kernels whose names contain
    ``kernel``, from a profile of ``calls`` calls (None if none ran)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    return sum(us) / calls / 1e3 if us else None


def grower(label: str, seed: int) -> None:
    import torch

    from repro_torch.core import decision_tree as dt
    from repro_torch.kernels.histogram import kernel as hk, ops as hist_ops
    from repro_torch.signal import eeg_data, pipeline

    gen = torch.Generator(device="cuda").manual_seed(seed)
    per = eeg_data.WINDOWS_PER_MATRIX
    rec = eeg_data.stratify_chunks(eeg_data.make_training_set(
        gen, 3, n_interictal_windows=16 * per, n_preictal_windows=16 * per))
    levels, calls = {}, {}
    level_fn, grow_fn = hist_ops.level_histogram, dt.fit_forest_binned

    def level_hook(*args, **kwargs):
        levels[kwargs["nodes_at"].bit_length() - 1] = (args, kwargs)
        return level_fn(*args, **kwargs)

    def grow_hook(*args, **kwargs):
        calls["grower"] = (args, kwargs)
        return grow_fn(*args, **kwargs)

    hist_ops.level_histogram, dt.fit_forest_binned = level_hook, grow_hook
    try:
        pipeline.fit(gen, rec, pipeline.PipelineConfig(), n_shards=2)
    finally:
        hist_ops.level_histogram, dt.fit_forest_binned = level_fn, grow_fn
    for lv in sorted(levels):
        args, kwargs = levels[lv]
        dev = device_ms(lambda: level_fn(*args, **kwargs), "hist_kernel")
        print(f"{label}: K4 level {lv} ({kwargs['nodes_at'] * kwargs['n_bins']} buckets, codes "
              f"{tuple(args[0].shape)} {str(args[0].dtype).split('.')[1]}): level_histogram "
              f"{time_ms(lambda: level_fn(*args, **kwargs)):.4f} ms, K4 device "
              + ("not measured" if dev is None else f"{dev:.4f} ms"), flush=True)
    args, kwargs = calls["grower"]
    hk.LAUNCHES = 0
    grow_fn(*args, **kwargs)
    torch.cuda.synchronize()
    launches = hk.LAUNCHES
    print(f"{label}: fit_forest_binned xb {tuple(args[0].shape)}: "
          f"{time_ms(lambda: grow_fn(*args, **kwargs), launches=3, reps=5):.3f} ms; K4 "
          f"launches {launches}", flush=True)


def gate(label: str, seeds: list[int], root: Path) -> None:
    """chip_smoke.py's training accuracy gate, on fresh draws: for each
    seed, a generator seeded with it draws the training set (patient 3, 16
    + 16 chunks), fits the default pipeline over 2 shards and draws a held-out
    timeline (one interictal hour); the line gives the port-trained forest's
    window accuracy on it, the committed JAX-trained program's, and the gap
    (the gate fails above 0.05)."""
    import torch

    from repro_torch.serving import api
    from repro_torch.signal import eeg_data, pipeline

    committed = api.ScoringProgram.load(str(root / "src/repro_torch/assets/seizure_program"),
                                        device="cuda")
    cfg, per = pipeline.PipelineConfig(), eeg_data.WINDOWS_PER_MATRIX
    gaps = []
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        rec = eeg_data.stratify_chunks(eeg_data.make_training_set(
            gen, 3, n_interictal_windows=16 * per, n_preictal_windows=16 * per))
        fitted = pipeline.fit(gen, rec, cfg, n_shards=2)
        timeline = eeg_data.make_test_timeline(gen, 3, hours_interictal=1)
        labels = timeline.labels.cpu()
        acc = float((pipeline.evaluate_timeline(fitted, timeline, cfg).window_preds.cpu()
                     == labels).float().mean())
        ref = float((pipeline.evaluate_program(committed, timeline).window_preds.cpu()
                     == labels).float().mean())
        gaps.append(ref - acc)
        print(f"{label}: gate seed {seed}: port-trained accuracy {acc:.4f}, committed "
              f"{ref:.4f}, gap {ref - acc:+.4f}{' (over 0.05)' if ref - acc > 0.05 else ''}",
              flush=True)
    print(f"{label}: gate over {len(seeds)} seeds: gap mean {statistics.mean(gaps):+.4f}, "
          f"max {max(gaps):+.4f}, {sum(gap > 0.05 for gap in gaps)} over 0.05", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    ap.add_argument("--seed", type=int, default=0)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--hybrid", action="store_true", help="K6 and a zamba2-7b prefill")
    mode.add_argument("--scoring", action="store_true",
                      help="K1, K2, the scoring stages, an engine step and a fit")
    mode.add_argument("--grower", action="store_true",
                      help="K4 at each level of a fit and one fit_forest_binned call")
    mode.add_argument("--gate", default=None, metavar="SEEDS",
                      help="the training accuracy gate on the draws of these seeds (0,1,2)")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    label = args.label or root.name
    sys.path.insert(0, str(root / "src"))

    import torch

    if not torch.cuda.is_available():
        print("ab_kernels.py needs a CUDA card; none is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{label}: {smi}; port from {root / 'src' / 'repro_torch'}", flush=True)
    if args.scoring:
        scoring(label, args.seed, root)
    elif args.grower:
        grower(label, args.seed)
    elif args.gate is not None:
        gate(label, [int(v) for v in args.gate.split(",")], root)
    else:
        (hybrid if args.hybrid else dense)(label, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
