#!/usr/bin/env python3
"""Time K6's states and outputs modes with one part of the work removed per
variant, to see what bounds each mode.

Run from the root of a checkout, on one CUDA card:

    python3 tools/ssd_ablate.py

Each variant is a text edit of a copy of ``src/repro_torch/csrc/ssd_chunks.cu``
in a temporary directory (the checkout is left as it is), built with the
port's nvcc flags (all variants compiled together, as tools/ssd_faults.py
does) and loaded in place of the port's kernel library. For each it prints
the states and outputs modes' times (CUDA events, as chip_smoke.py times
kernels) at the static prefill's grouped shape: 8 batch rows, 8 chunks of
256, 112 heads of 64, bf16. A variant's results are wrong by design; only
its time is read: the difference to "base" is what the removed part costs
where it is not hidden under the rest.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke as cs  # noqa: E402  (chip_smoke puts src/ on the path)
from flash_faults import build_variants, use  # noqa: E402

_DECAY = ("              p[0] = sc[4 * j + 0] * (rf_a * kf.x);\n"
          "              p[1] = sc[4 * j + 1] * (rf_a * kf.y);\n"
          "              p[2] = sc[4 * j + 2] * (rf_b * kf.x);\n"
          "              p[3] = sc[4 * j + 3] * (rf_b * kf.y);\n")
_HEADS = ("  const long long want = (items + 4LL * sm_count(device) - 1) / "
          "(4LL * sm_count(device));")

# name: (what is removed or changed, edits of the source)
VARIANTS = {
    "base": ("nothing", []),
    "no_y_store": ("outputs: the TMA store of each y slab",
                   [("          tma_store(ys, &tm_y, 0, h, slab * 64, w.c, w.g);\n", "")]),
    "no_decay_math": ("outputs: the decay of every key tile (P = q k^T, rounded)",
                      [(_DECAY, "              p[0] = sc[4 * j + 0];\n"
                                "              p[1] = sc[4 * j + 1];\n"
                                "              p[2] = sc[4 * j + 2];\n"
                                "              p[3] = sc[4 * j + 3];\n"),
                       ("p[e] = kx <= rx ? sc[4 * j + e] * __expf(dx) : 0.f;",
                        "p[e] = sc[4 * j + e];")]),
    "no_pv": ("outputs: the P v products",
              [("            wgmma_rs_n64(acc, pa[kt % 2][kk],",
                "            if (kk < 0) wgmma_rs_n64(acc, pa[kt % 2][kk],")]),
    "no_qh": ("outputs: the q h_in products (three bf16 terms)",
              [("        for (int term = 0; term < 3; ++term) {",
                "        for (int term = 0; term < 0; ++term) {")]),
    "states_one_term": ("states: the middle and low bf16 terms of dte k",
                        [("        wgmma_rs_n64(acc, cur[1], desc_v);\n"
                          "        wgmma_rs_n64(acc, cur[2], desc_v);\n", "")]),
    "states_no_products": ("states: every k-step's split and products",
                           [("      for (; ks + 1 < ks1; ks += 2) {",
                             "      for (ks = ks1; ks + 1 < ks1; ks += 2) {")]),
    "states_no_store": ("states: the state's stores",
                        [("          *reinterpret_cast<float2*>(sb + d_a * kD + col) = "
                          "make_float2(o[0], o[1]);\n", "")]),
    "heads_8": ("both: 8 heads per block (base: about four waves of blocks, 14)",
                [(_HEADS, "  const long long want = 8;")]),
    "heads_16": ("both: 16 heads per block", [(_HEADS, "  const long long want = 16;")]),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssd_ablate.py needs a CUDA card; none is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import kernel as sk

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    case = ("static prefill", "grouped", 8, 8, 256, 112, "bfloat16", "model")
    q, k, v, ld, h_in = cs.ssd_inputs(gen, case)
    bounds = {m: cs.ssd_bound(m, *case[2:6], "bfloat16")[0] for m in ("states", "outputs")}
    print(f"K6 at (8, 8, 256, 112, 64) bf16: bound states {bounds['states']:.4f} ms, "
          f"outputs {bounds['outputs']:.4f} ms (bytes)")
    variants = {name: ("", (), edits) for name, (_, edits) in VARIANTS.items()}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(build, Path(tmp), "ssd_chunks.cu", variants)
        for name, (what, _) in VARIANTS.items():
            use(build, libs[name])
            s = cs.time_ms(lambda: sk.ssd_chunk_states(k, v, ld))
            o = cs.time_ms(lambda: sk.ssd_chunk_outputs(q, k, v, ld, h_in))
            print(f"variant {name} (removed: {what}): states {s:.4f} ms, outputs {o:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
