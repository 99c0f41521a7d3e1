#!/usr/bin/env python3
"""Plant faults in K5 (``src/repro_torch/csrc/flash_attention.cu``) and
show how far over chip_smoke.py's checks each one lands.

Run from the root of a checkout, on one CUDA card:

    python3 tools/flash_faults.py

Each fault is a text edit of a copy of the kernel source in a temporary
directory (the checkout is left as it is), built with the port's nvcc
flags (all variants compiled together) and loaded in place of the port's
kernel library. For the unchanged kernel and for each fault it prints:

- the share of chip_smoke.py's per-element K5 tolerance (FLASH_TOL) that
  the worst element uses at the static prefill's launch, q (8, 2048, 16,
  128) and k, v (8, 2048, 8, 128) causal in the model's layout, against
  ``ops.reference``; over 1, chip_smoke.py fails;
- for the bf16 variants, the largest difference between the last-token
  logits of one 2048-token qwen3-0.6b prefill (random weights, the K5
  launch (1, 2048, 16, 128)) and the plain path's, beside chip_smoke.py's
  end-to-end limit LM_LOGIT_TOL.

Exits 1 if the K5 check passes a fault or fails the unchanged kernel.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (chip_smoke puts src/ on the path)

B, H, KV, S, HD = 8, 16, 8, 2048, 128  # the static prefill's K5 launch
PROMPT = 2048

# bf16 body (TMA + wgmma): the rescale of the accumulator, the test that
# sends a tile through the mask, the mask.
_RESCALE = ("        o[4 * j + 0] *= alpha[0];\n        o[4 * j + 1] *= alpha[0];\n"
            "        o[4 * j + 2] *= alpha[1];\n        o[4 * j + 3] *= alpha[1];\n")
_EDGE = "      if (k0 + kTK > s || (causal && k0 + kTK - 1 > row_lo)) {\n"
_MASK = "          if (key >= s || (causal && key > row)) sc[i] = kNegInf;\n"
# f32 body: the head of its k-tile loop.
_F32_HEAD = ("  for (int k0 = 0; k0 < k_end; k0 += kBK) {\n"
             "    __syncthreads();  // the previous tile's readers are done\n")


def _masked(cond: str) -> list[tuple[str, str]]:
    """Edits that send the tiles where ``cond`` holds through the mask and
    mask the keys where it holds."""
    return [(_EDGE, _EDGE.replace("if (", f"if ({cond} || ")),
            (_MASK, _MASK.replace("key > row)", f"key > row) || {cond}"))]


# name: (what the fault does, the types it is read in, edits of the source)
FAULTS = {
    "none": ("the kernel as committed", ("bfloat16", "float32"), []),
    "skip_tile": ("bf16: rows >= 1024 skip the k tile of keys 512-639", ("bfloat16",),
                  _masked("(q0 >= 1024 && k0 == 512)")),
    "no_rescale": ("bf16: the accumulator is not rescaled by alpha after the first two "
                   "k tiles", ("bfloat16",),
                   [(_RESCALE, "        if (it < 2) {\n" + _RESCALE + "        }\n")]),
    "one_key": ("bf16: rows >= 1024 drop key 0", ("bfloat16",),
                [(_EDGE, _EDGE.replace("if (", "if (k0 == 0 || ")),
                 (_MASK, _MASK.replace("key > row)", "key > row) || (key == 0 && row >= 1024)"))]),
    "f32_skip_tile": ("f32: rows >= 1024 skip the k tile of keys 512-575", ("float32",),
                      [(_F32_HEAD, _F32_HEAD + "    if (q0 >= 1024 && k0 == 512) continue;\n")]),
}


def build_variants(build, tmp: Path, source: str = "flash_attention.cu",
                   faults: dict = FAULTS) -> dict[str, Path]:
    """Each variant's library (the edited ``source``, the shared error
    entry and the headers), all nvcc processes started together."""
    text0 = (build.CSRC / source).read_text()
    nvcc = build._nvcc()
    jobs = []
    for name, (_, _, edits) in faults.items():
        text = text0
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the text to edit is not in the source exactly once")
            text = text.replace(old, new)
        d = tmp / name
        d.mkdir()
        (d / source).write_text(text)
        for shared in [build.CSRC / "common.cu", *build._headers()]:
            shutil.copy(shared, d)
        objs = [d / Path(source).with_suffix(".o").name, d / "common.o"]
        procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-c", str(o.with_suffix(".cu")),
                                   "-o", str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for o in objs]
        jobs.append((name, d, objs, procs))
    libs = {}
    for name, d, objs, procs in jobs:
        for proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed on the {name} variant:\n{out}")
        libs[name] = d / "libvariant.so"
        subprocess.run([nvcc, "-shared", "-o", str(libs[name]), *map(str, objs)],
                       check=True, capture_output=True)
    return libs


def use(build, lib: Path) -> None:
    """Serve the port's kernel launches from ``lib`` (the loader keeps one
    library and a table of its looked-up functions)."""
    so = ctypes.CDLL(str(lib))
    so.repro_error_string.argtypes = [ctypes.c_int]
    so.repro_error_string.restype = ctypes.c_char_p
    build._lib = so
    build._functions.clear()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_faults.py needs a CUDA card; none is available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as ak, ops as ao
    from repro_torch.models import build as build_model

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    inputs = {n: [torch.randn((B, S, heads, HD), generator=gen, device="cuda").to(dt)
                  for heads in (H, KV, KV)]
              for n, dt in dtypes.items()}
    want = {n: ao.reference(*qkv, causal=True) for n, qkv in inputs.items()}

    cfg = get_config(cs.LM_ARCH)
    model = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(cs.SEED),
                                  device="cuda")
    model.compute_params()
    tokens = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        2, cfg.vocab_size, size=(1, PROMPT)).astype(np.int32)).to("cuda")

    def last_logits():
        return model.prefill({"tokens": tokens}, PROMPT)[0][:, -1].float()

    with cs.plain_versions():
        plain_logits = last_logits()

    wrong = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(build, Path(tmp))
        for name, (what, types, _) in FAULTS.items():
            use(build, libs[name])
            shares = {t: cs.flash_share(ak.flash_attention(*inputs[t], causal=True), want[t])
                      for t in types}
            caught = max(shares.values()) > 1.0
            text = ", ".join(f"{t} {s:.4f}" for t, s in shares.items())
            line = (f"fault {name} ({what}): worst element uses {text} of its K5 tolerance "
                    f"({'caught' if caught else 'passes'})")
            if "bfloat16" in types:
                diff = float((last_logits() - plain_logits).abs().max())
                line += (f"; prefill last-token logits differ from the plain path's by "
                         f"{diff:.4f} (LM_LOGIT_TOL {cs.LM_LOGIT_TOL}: "
                         f"{'caught' if diff > cs.LM_LOGIT_TOL else 'passes'})")
            print(line)
            if caught != (name != "none"):
                wrong.append(name)
    if wrong:
        print(f"FAIL: the K5 check misjudged {wrong}", file=sys.stderr)
        return 1
    print("every planted fault fails the K5 check; the committed kernel passes it")
    return 0


if __name__ == "__main__":
    sys.exit(main())
