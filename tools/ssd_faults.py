#!/usr/bin/env python3
"""Plant faults in K6 (``src/repro_torch/csrc/ssd_chunks.cu``) and show how
far over chip_smoke.py's K6 check each one lands.

Run from the root of a checkout, on one CUDA card:

    python3 tools/ssd_faults.py

Each fault is a text edit of a copy of the kernel source in a temporary
directory (the checkout is left as it is), built with the port's nvcc
flags (all variants compiled together) and loaded in place of the port's
kernel library. For the unchanged kernel and for each fault it prints, for
every case of chip_smoke.py's SSD_CASES in the types the fault is read in,
the share of the per-element K6 tolerance (SSD_TOL) that the worst
element of y or of the state uses; over 1 in any case, chip_smoke.py
fails.

Exits 1 if the K6 check passes a fault or fails the unchanged kernel.
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

_BF16 = ("bfloat16",)
_EXP = ("    const float ea = expf(cum_s[row_a]);\n"
        "    const float eb = expf(cum_s[row_b]);\n")
_MASK = "p[e] = key <= row ? "

# name: (what the fault does, the types it is read in, edits of the source)
FAULTS = {
    "none": ("the kernel as committed", ("bfloat16", "float32"), []),
    "no_hin_late": ("bf16: rows >= 128 drop the (q exp(cum)) h_in term", _BF16,
                    [(_EXP, _EXP.replace("= expf(cum_s[row_a])", "= row_a >= 128 ? 0.f : "
                                         "expf(cum_s[row_a])")
                            .replace("= expf(cum_s[row_b])", "= row_b >= 128 ? 0.f : "
                                     "expf(cum_s[row_b])"))]),
    "mask_off_by_one": ("bf16: the causal mask drops the diagonal (key < row)", _BF16,
                        [(_MASK, "p[e] = key < row ? ")]),
    "no_state_hin": ("the exp(cum_L) h_in term is missing from the state", _BF16,
                     [("const float et = expf(cum_s[L - 1]);", "const float et = 0.f;")]),
    "one_key": ("bf16: rows >= 128 drop key 128, the first key of a late tile", _BF16,
                [(_MASK, "p[e] = key <= row && !(row >= 128 && key == 128) ? ")]),
    "f32_mask_off_by_one": ("f32: the causal mask drops the diagonal", ("float32",),
                            [("key <= row ? sc[i][j] * expf(", "key < row ? sc[i][j] * expf(")]),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssd_faults.py needs a CUDA card; none is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    cases = cs.ssd_case_inputs(torch.Generator(device="cuda").manual_seed(cs.SEED))

    wrong = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(build, Path(tmp), "ssd_chunks.cu", FAULTS)
        for name, (what, types, _) in FAULTS.items():
            use(build, libs[name])
            shares = {}
            for case, inputs, want in cases:
                if case[4] in types:
                    share_y, share_s, _ = cs.ssd_shares(case, inputs, want)
                    shares[case[0]] = max(share_y, share_s)
            caught = max(shares.values()) > 1.0
            text = ", ".join(f"{c} {s:.4f}" for c, s in shares.items())
            print(f"fault {name} ({what}): worst element uses, by case, {text} of its K6 "
                  f"tolerance ({'caught' if caught else 'passes'})")
            if caught != (name != "none"):
                wrong.append(name)
    if wrong:
        print(f"FAIL: the K6 check misjudged {wrong}", file=sys.stderr)
        return 1
    print("every planted fault fails the K6 check; the committed kernel passes it")
    return 0


if __name__ == "__main__":
    sys.exit(main())
