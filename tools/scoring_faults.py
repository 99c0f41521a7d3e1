#!/usr/bin/env python3
"""Plant faults in K1 (``src/repro_torch/csrc/forest.cu``) and K2
(``src/repro_torch/csrc/wpd_level.cu``) and show how far over chip_smoke.py's
K1 and K2 checks each one lands.

Run from the root of a checkout, on one CUDA card:

    python3 tools/scoring_faults.py

Each fault is a text edit of a copy of one kernel source in a temporary
directory (the checkout is left as it is), built with the port's nvcc flags
(all variants compiled together) and loaded in place of the port's kernel
library. For the unchanged kernels and for each fault it prints, for every
case of chip_smoke.py's phase 2 that the source serves, the share of its
tolerance that the check uses (chip_smoke.py::forest_check on K1_ROWS of the
committed program; wpd_check on K2_LEVEL_CASES; multilevel_check on
K2_CASES and on a fit's (180, 2048) at levels 4 and 5, which also holds the
one launch bit-equal to the chained single level); over 1, or a bit
difference, and chip_smoke.py fails.

Exits 1 if the K1 and K2 checks pass a fault or fail an unchanged kernel.
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

_WRAP = "    idx = idx >= len ? idx - len : idx;\n"
_PALEY = ("      auto tree_a = [=](int, int s, int m) { return o + s * len + m; };"
          "         // node 2i: the low branch\n"
          "      auto tree_d = [=](int, int s, int m) { return o + s * len + half + m; };"
          "  // node 2i + 1: the high branch\n")
_SWAP = "    const int t = src; src = dst; dst = t;\n"
_DETAIL = "    float* d_scale = out + p.off[lev] + row0 * half;"
_LEAF = "      if (t0 + u < n_trees) {  // trees in ascending order"
_STEP = "        node[u] = v[u] > th[u] ? nx[u].y : nx[u].x;\n"
_REDUCE = "      // Butterfly sum over the lanes: every lane ends with the node value.\n"

# source: {name: (what the fault does, edits of the source)}
FAULTS = {
    "wpd_level.cu": {
        "none": ("the kernel as committed", []),
        "wrap_off_by_one": ("K2: a read past the row's end wraps to index 4 instead of 0 "
                            "(one 16-byte read off)",
                            [(_WRAP, _WRAP.replace("idx - len :", "idx - len + 4 :"))]),
        "paley_swapped": ("K2: the tree's second level puts the high branch before the low one",
                          [(_PALEY, _PALEY.replace("+ s * len + m;", "+ s * len + (lev == 1 ? half : 0) + m;")
                            .replace("+ s * len + half + m;", "+ s * len + (lev == 1 ? 0 : half) + m;"))]),
        "stale_buffer": ("K2: the third level reads the first level's output again",
                         [(_SWAP, "    if (lev != 1) { const int t = src; src = dst; dst = t; }\n")]),
        "detail_misplaced": ("K2: D1 is written at D2's place",
                             [(_DETAIL, _DETAIL.replace("p.off[lev]", "p.off[lev == 0 ? 1 : lev]"))]),
    },
    "forest.cu": {
        "none": ("the kernel as committed", []),
        "last_tree_dropped": ("K1: the last tree's leaf is not summed",
                              [(_LEAF, _LEAF.replace("< n_trees", "< n_trees - 1"))]),
        "path_short": ("K1: a walk whose left side ends in a leaf stops there, a level short",
                       [(_STEP, "        node[u] = nx[u].x >= n_leaves ? nx[u].x : "
                                "(v[u] > th[u] ? nx[u].y : nx[u].x);\n")]),
        "lane_dropped": ("K1: lane 31's partial sum is left out of the reduce",
                         [(_REDUCE, "      for (int u = 0; u < kGroup; ++u) if (lane == 31) v[u] = 0.f;\n"
                           + _REDUCE)]),
    },
}


def k2_cases(gen) -> list:
    """(label, check) for each K2 case: check() -> (share of the tolerance,
    bit-equal to the chained single level)."""
    import torch

    cases = []
    for shape in cs.K2_LEVEL_CASES:
        x = torch.randn(shape, generator=gen, device="cuda")
        cases.append((f"wpd_level {shape}", lambda x=x: (lambda e, t: (e / t, True))(*cs.wpd_check(x))))
    fit = (180, 2048)
    for kind, shape, level in cs.K2_CASES + (("wpd_tree", fit, 4), ("dwt_levels", fit, 5)):
        x = torch.randn(shape, generator=gen, device="cuda")

        def check(kind=kind, x=x, level=level):
            err, tol, bits = cs.multilevel_check(kind, x, level)
            return err / tol, bits

        cases.append((f"{kind} {shape} L{level}", check))
    return cases


def k1_cases(gen) -> list:
    import torch

    from repro_torch.serving import api

    program = api.ScoringProgram.load(str(ROOT / "src/repro_torch/assets/seizure_program"),
                                      device="cuda")
    cases = []
    for b in cs.K1_ROWS:
        x = torch.randn((b, program.packed.proj.shape[1]), generator=gen, device="cuda")

        def check(x=x):
            err, tol, _, _ = cs.forest_check(x, program.packed)
            return err / tol, True

        cases.append((f"forest ({b}, 288)", check))
    return cases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scoring_faults.py needs a CUDA card; none is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    cases = {"wpd_level.cu": k2_cases(gen), "forest.cu": k1_cases(gen)}

    wrong = []
    with tempfile.TemporaryDirectory() as tmp:
        for source, faults in FAULTS.items():
            d = Path(tmp) / source.split(".")[0]
            d.mkdir()
            libs = build_variants(build, d, source,
                                  {n: (what, (), edits) for n, (what, edits) in faults.items()})
            for name, (what, _) in faults.items():
                use(build, libs[name])
                read = [(label, *check()) for label, check in cases[source]]
                caught = any(not share <= 1.0 or not bits for _, share, bits in read)
                text = ", ".join(f"{label} {share:.4g}{'' if bits else ' (bits differ)'}"
                                 for label, share, bits in read)
                print(f"fault {source}:{name} ({what}): share of the tolerance by case: {text} "
                      f"({'caught' if caught else 'passes'})", flush=True)
                if caught != (name != "none"):
                    wrong.append(f"{source}:{name}")
    if wrong:
        print(f"FAIL: the K1 and K2 checks misjudged {wrong}", file=sys.stderr)
        return 1
    print("every planted fault fails the K1 and K2 checks; the committed kernels pass them")
    return 0


if __name__ == "__main__":
    sys.exit(main())
