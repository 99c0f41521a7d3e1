#!/usr/bin/env python3
"""Time K5 and K3 and one qwen3-0.6b static prefill in the port of a given
checkout, so that two checkouts can be compared in one call on one card.

Run from the root of a checkout, on one CUDA card:

    python3 tools/ab_kernels.py                      # this checkout
    python3 tools/ab_kernels.py --root path/to/other/checkout

The other checkout's ``src/repro_torch`` is imported (and its kernels
built) in place of this one's; run the two in turns in separate processes
(A, B, B, A) and compare within the call. Each line starts with the label
(--label, default the root's name):

- K5 through ``ops.flash_attention`` at the static prefill's launch, q (8,
  2048, 16, 128) and k, v (8, 2048, 8, 128) bf16 causal in the model's
  layout: the route as attn_apply calls it (a port whose kernel takes
  (B*H, S, hd) expands and copies around the launch), and the kernel
  launch alone;
- K3 at the scoring path's (32, 1024, 180) and (32, 64, 186) and a fit's
  (1, 1024, 180), each a transposed view as pca.fit_T hands it over;
- one static prefill (8, 2048) of qwen3-0.6b (random bf16 weights from
  --seed): median wall ms of 3 (synchronized), then one profile: device
  busy ms, K5's ms and launches, and the copies' (memcpy activities and
  kernels named *copy*, the filter chip_smoke.py's "lm trace" line uses).

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    label = args.label or root.name
    sys.path.insert(0, str(root / "src"))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ab_kernels.py needs a CUDA card; none is available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as ak, ops as ao
    from repro_torch.kernels.gram import kernel as gk
    from repro_torch.models import build as build_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{label}: {smi}; port from {root / 'src' / 'repro_torch'}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
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

    cfg = get_config("qwen3-0.6b")
    model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(args.seed),
                                  device="cuda")
    model.compute_params()
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        2, cfg.vocab_size, size=(b, s)).astype(np.int32)).to("cuda")

    def prefill():
        return model.prefill({"tokens": tokens}, 4096)

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
    busy, end, k5, copies = 0.0, float("-inf"), [0.0, 0], [0.0, 0]
    for e in device:
        busy += max(0.0, e.time_range.end - max(e.time_range.start, end))
        end = max(end, e.time_range.end)
        ms = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        for acc, hit in ((k5, "flash_fwd" in name), (copies, "copy" in name)):
            if hit:
                acc[0] += ms
                acc[1] += 1
    print(f"{label}: qwen3-0.6b static prefill ({b}, {s}): {statistics.median(walls):.3f} ms "
          f"(median of 3, synchronized); profiled: device busy {busy / 1e3:.3f} ms, K5 "
          f"{k5[0]:.3f} ms in {k5[1]} launches, copies {copies[0]:.3f} ms in {copies[1]} "
          "activities")
    return 0


if __name__ == "__main__":
    sys.exit(main())
