#!/usr/bin/env python3
"""Plant faults in K6 (``src/repro_torch/csrc/ssd_chunks.cu``) and show how
far over chip_smoke.py's K6 checks each one lands.

Run from the root of a checkout, on one CUDA card:

    python3 tools/ssd_faults.py

Each fault is a text edit of a copy of the kernel source in a temporary
directory (the checkout is left as it is), built with the port's nvcc
flags (all variants compiled together) and loaded in place of the port's
kernel library. For the unchanged kernel and for each fault it prints, for
every case of chip_smoke.py's SSD_CASES in the types the fault is read in,
the largest share of its tolerance that an element uses over the case's
checks (chip_smoke.py::ssd_shares: the full function's y and state; each
mode against its plain version and against the plain version on float32
copies; the states mode handed a nonzero h_in, inf if its bits change);
over 1 in any case, chip_smoke.py fails.

Exits 1 if the K6 checks pass a fault or fail the unchanged kernel.
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
_EXP = ("        const float ea = tab[kTabEcum + row_a];\n"
        "        const float eb = tab[kTabEcum + row_b];\n")
_MASK = "p[e] = kx <= rx ? "
_QK = ("      tma_load(base + S::kK, &tm_k, qk_full, 0, 0, w.c, w.g);\n"
       "      if (S::kY) tma_load(base + S::kQ, &tm_q, qk_full, 0, 0, w.c, w.g);\n")
_HIN = "if (MODE == kFull) {  // + exp(cum_L) h_in"

# name: (what the fault does, the types it is read in, edits of the source)
FAULTS = {
    "none": ("the kernel as committed", ("bfloat16", "float32"), []),
    "no_hin_late": ("bf16: rows >= 128 drop the (q exp(cum)) h_in term", _BF16,
                    [(_EXP, _EXP.replace("= tab", "= row_a >= 128 ? 0.f : tab", 1)
                            .replace("eb = tab", "eb = row_b >= 128 ? 0.f : tab"))]),
    "mask_off_by_one": ("bf16: the causal mask drops the diagonal (key < row)", _BF16,
                        [(_MASK, "p[e] = kx < rx ? ")]),
    "no_state_hin": ("bf16: the exp(cum_L) h_in term is missing from the full state", _BF16,
                     [("const float et = expf(cl);", "const float et = 0.f;")]),
    "one_key": ("bf16: rows >= 128 drop key 128, the first key of a late tile", _BF16,
                [(_MASK, "p[e] = kx <= rx && !(rx >= 128 && kx == 128) ? ")]),
    "f32_mask_off_by_one": ("f32: the causal mask drops the diagonal", ("float32",),
                            [("key <= row ? sc[i][j] * expf(", "key < row ? sc[i][j] * expf(")]),
    "wrong_group": ("bf16: a block reads the next batch row's B and C", _BF16,
                    [(_QK, _QK.replace("w.c, w.g);", "w.c, (w.g + 1) % lay.groups);"))]),
    "dropped_split": ("bf16: the state product drops the middle bf16 term of dte k", _BF16,
                      [("        wgmma_rs_n64(acc, cur[1], desc_v);\n", "")]),
    "below_diag_decay": ("bf16: key tiles below the diagonal drop the rows' decay factor", _BF16,
                         [("              p[0] = sc[4 * j + 0] * (rf_a * kf.x);\n"
                           "              p[1] = sc[4 * j + 1] * (rf_a * kf.y);\n",
                           "              p[0] = sc[4 * j + 0] * kf.x;\n"
                           "              p[1] = sc[4 * j + 1] * kf.y;\n")]),
    "states_read_hin": ("bf16: the states mode adds exp(cum_L) h_in when it is handed one",
                        _BF16, [(_HIN, _HIN.replace("MODE == kFull", "MODE == kFull || h_in"))]),
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
                if case[6] in types:
                    by_check, _ = cs.ssd_shares(case, inputs, want)
                    worst = max(by_check, key=by_check.get)
                    shares[f"{case[1]} {case[0]}"] = (by_check[worst], worst)
            caught = max(s for s, _ in shares.values()) > 1.0
            text = ", ".join(f"{c} {s:.4f} ({w})" for c, (s, w) in shares.items())
            print(f"fault {name} ({what}): worst element uses, by case, {text} of its K6 "
                  f"tolerance ({'caught' if caught else 'passes'})")
            if caught != (name != "none"):
                wrong.append(name)
    if wrong:
        print(f"FAIL: the K6 checks misjudged {wrong}", file=sys.stderr)
        return 1
    print("every planted fault fails the K6 checks; the committed kernel passes them")
    return 0


if __name__ == "__main__":
    sys.exit(main())
