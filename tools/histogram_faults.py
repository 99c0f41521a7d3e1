#!/usr/bin/env python3
"""Plant faults in K4 (``src/repro_torch/csrc/histogram.cu``) and show
which of chip_smoke.py's K4 checks each one fails; time the kernel beside
the other design of its shallow levels.

Run from the root of a checkout, on one CUDA card:

    python3 tools/histogram_faults.py

The K4 inputs are chip_smoke.py's: the default MapReduce fit over 2 shards
of 16 + 16 chunks (chip_smoke.training_set, timed_fit), which hands the
level mode its inputs at every level, the level mode's ragged_level_cases,
and the class mode's cases (class_inputs at levels 0 and 5, sliced_case).
Each variant is a text edit of a copy of the source in a temporary
directory (the checkout is left as it is), built with the port's nvcc
flags (all variants compiled together) and loaded in place of the port's
kernel library. For each it prints the level mode's error on 0/1 weights
(0 required) and relative error on float weights (1e-5) in every case, and
the class mode's; any check over its limit, and chip_smoke.py fails.

ALTERNATIVES are other designs, held to the same checks and timed beside
the committed kernel at every level: CUDA events around 20 back-to-back
calls (median of 7), and the kernel's device time from a profile of 20.

Exits 1 if the K4 checks pass a fault or fail the committed kernel or an
alternative.
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

SOURCE = "histogram.cu"
_BASE = "        base[k] = in ? a.local[i] * a.n_bins : 0;\n"
_MERGE = "  for (int k = 1; k < copies; ++k) {\n"
_BARRIER = "  __syncthreads();  // every copy is complete\n"
_STRIDE = "    for (int i = tid; i < total; i += kThreads) {\n"
_ROW = "      auto row = [&](int g) { return src + static_cast<long long>(g) * a.n; };\n"
_ADD = ("      if (b >= lo && b < hi) atomicAdd(&mine[g * width + (b - lo) * c_dim + (key >> 16)], "
        "rec_w[r]);\n")
_COPIES = "    if (kWarps * group * feature + staging <= kCopyBudget) {\n"
_TILE = "constexpr int kTile = 1024;"
_GROUP = ("  while (group > 1 && static_cast<long long>(n_trees) * "
          "((a->f_dim + group - 1) / group) <\n")

# name: (what it does, edits of the source)
FAULTS = {
    "none": ("the kernel as committed", []),
    "node_off_by_one": ("a bucket one node off: local * n_bins + code + n_bins",
                        [(_BASE, _BASE.replace("a.n_bins :", "a.n_bins + a.n_bins :"))]),
    "copy_left_out": ("the last per-warp copy is left out of the merge",
                      [(_MERGE, _MERGE.replace("k < copies", "k < copies - 1"))]),
    "no_merge_barrier": ("no barrier between the last adds and the merge",
                         [(_BARRIER, "")]),
    "stride_tail_dropped": ("each thread drops the last (feature, record) of its stride",
                            [(_STRIDE, _STRIDE.replace("i < total", "i + kThreads < total"))]),
    "group_stride": ("the group's code rows are read a pass apart, not a row of N apart",
                     [(_ROW, _ROW.replace("* a.n; }", "* a.tile; }"))]),
}

# match_any: warp-aggregated atomics in one shared histogram, the lanes that
# add to one word (__match_any_sync) summing their masses by shuffles, one of
# them adding. two_passes: the samples staged 512 at a time. group_2,
# group_8: 2 or 8 features a block, not as many as keep two blocks an SM.
ALTERNATIVES = {
    "two_passes": ("passes of 512 samples (two at a shard's 960)",
                   [(_TILE, "constexpr int kTile = 512;")]),
    "group_2": ("2 features a block", [(_GROUP, "  group = 2;\n" + _GROUP)]),
    "group_8": ("8 features a block", [(_GROUP, _GROUP.replace("group > 1", "group > 8"))]),
    "match_any": ("one histogram copy, warp-aggregated atomics (__match_any_sync)", [
        (_COPIES, "    if (false) {\n"),
        (_ADD, "      const bool in = b >= lo && b < hi;\n"
               "      const int addr = in ? g * width + (b - lo) * c_dim + (key >> 16) : -1;\n"
               "      const unsigned active = __activemask();\n"
               "      const unsigned peers = __match_any_sync(active, addr);\n"
               "      float sum = 0.f;\n"
               "      for (int k = 0; k < 32; ++k) {\n"
               "        const float v = __shfl_sync(active, rec_w[r], k);\n"
               "        if ((peers >> k) & 1u) sum += v;\n"
               "      }\n"
               "      if (in && lane == __ffs(peers) - 1) atomicAdd(&mine[addr], sum);\n"),
    ]),
}


def k4_cases(captured, gen) -> list:
    """(label, check) for each of chip_smoke.py's K4 checks; check() ->
    (error on 0/1 masses, relative error on float masses)."""
    cases = [(f"level {lv}", lambda lv=lv: cs.level_check(captured[lv], gen))
             for lv in sorted(captured)]
    cases += [(label, lambda a=inputs: cs.level_check(a, gen))
              for label, inputs in cs.ragged_level_cases(gen).items()]
    for lv in (max(captured), min(captured)):
        args = cs.class_inputs(captured[lv])
        cases.append((f"class L{lv}", lambda args=args: cs.class_check(*args, gen)))
    codes, wy, nb = cs.sliced_case(gen)
    cases.append(("class sliced", lambda: cs.class_check(codes, wy, nb, gen)))
    return cases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("histogram_faults.py needs a CUDA card; none is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.signal import pipeline

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    _, _, captured = cs.timed_fit(gen, cs.training_set(gen), pipeline.PipelineConfig())
    levels = captured["histogram"]
    cases = k4_cases(levels, gen)

    wrong = []
    with tempfile.TemporaryDirectory() as tmp:
        variants = {**FAULTS, **ALTERNATIVES}
        libs = build_variants(build, Path(tmp), SOURCE,
                              {n: (what, (), edits) for n, (what, edits) in variants.items()})
        for name, (what, _) in variants.items():
            use(build, libs[name])
            read = [(label, *check()) for label, check in cases]
            caught = any(err != 0.0 or not rel <= 1e-5 for _, err, rel in read)
            text = ", ".join(f"{label} {err:.3g}/{rel:.2g}" for label, err, rel in read)
            kind = "fault" if name in FAULTS else "alternative"
            line = (f"{kind} {name} ({what}): error on 0/1 masses / relative error on float "
                    f"masses by case: {text} ({'caught' if caught else 'passes'})")
            if name == "none" or name in ALTERNATIVES:
                times = []
                for lv in sorted(levels):
                    codes, local, y, w, kw = levels[lv]

                    def call():
                        return hk.level_histogram(codes, local, y, w, **kw)

                    dev = cs.device_ms(call, "hist_kernel")
                    times.append(f"L{lv} {cs.time_ms(call):.4f} (device "
                                 + ("not measured" if dev is None else f"{dev:.4f}") + ")")
                line += f"; level mode ms a call: {', '.join(times)}"
            print(line, flush=True)
            if caught != (name in FAULTS and name != "none"):
                wrong.append(name)
    if wrong:
        print(f"FAIL: the K4 checks misjudged {wrong}", file=sys.stderr)
        return 1
    print("every planted fault fails a K4 check; the committed kernel and the alternatives "
          "pass them")
    return 0


if __name__ == "__main__":
    sys.exit(main())
