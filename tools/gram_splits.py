#!/usr/bin/env python3
"""Time K3 (``src/repro_torch/csrc/gram.cu``) at every split of the sample
axis, at the shapes of the scoring path and of a fit, beside the split
that ``kernels/gram/kernel.py::split_plan`` picks and ``torch.matmul``.

Run from the root of a checkout, on one CUDA card:

    python3 tools/gram_splits.py

Each line: the shape (batch, n, P) as pca.fit_T hands it over (a
transposed view), the split count and chunk, the kernel's time through its
C entry (CUDA events around 20 back-to-back launches, the tile pass and,
when split, the reduce pass) and its largest error relative to max|G|.
Then the wrapper's time at split_plan's choice, and torch.matmul's.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (chip_smoke puts src/ on the path)

SHAPES = {"scoring": (32, 1024, 180), "scoring halo": (32, 64, 186),
          "fit": (1, 1024, 180), "fit n=256": (1, 256, 180), "fit n=128": (1, 128, 180),
          "fit halo n=64": (1, 64, 186)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gram_splits.py needs a CUDA card; none is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.gram import kernel as gk, ref as gr

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    fn = build.function("repro_gram", gk._ARGTYPES)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (b, n, p) in SHAPES.items():
        x = torch.randn((b, p, n), generator=gen, device="cuda").transpose(1, 2)
        want = gr.gram(x)
        slabs = -(-n // gk.SLAB)
        splits = sorted({-(-n // (-(-slabs // k) * gk.SLAB)) for k in range(1, slabs + 1)})
        for n_split in splits:
            chunk = -(-slabs // n_split) * gk.SLAB
            out = torch.empty((b, p, p), device="cuda")
            part = torch.empty((b, n_split, gk.upper_tiles(p), gk.TILE, gk.TILE), device="cuda")
            args = (x.data_ptr(), out.data_ptr(), part.data_ptr(), b, n, p, *x.stride(), n_split,
                    chunk, gk.load_mode(x), 0, build.stream_of(x))
            build.check(fn(*args), "gram")
            torch.cuda.synchronize()
            err = float((out - want).abs().max() / want.abs().max())
            print(f"gram split {name} {(b, n, p)}: {n_split} x {chunk} samples: "
                  f"{cs.time_ms(lambda: fn(*args)):.4f} ms, error {err:.2e} of max|G|")
        print(f"gram split {name} {(b, n, p)}: split_plan {gk.split_plan(b, n, p, sms)}, wrapper "
              f"{cs.time_ms(lambda: gk.gram(x)):.4f} ms, torch.matmul "
              f"{cs.time_ms(lambda: torch.matmul(x.transpose(-1, -2), x)):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
