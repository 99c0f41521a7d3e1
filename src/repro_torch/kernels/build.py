"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All sources under ``repro_torch/csrc`` are compiled for ``sm_90a`` (one
``nvcc -c`` per source, all started together), linked into ONE shared
library with a plain C interface, and loaded with ``ctypes``. The
library lives under ``build/repro_torch/`` at the root of the checkout,
named by a hash of the sources and flags, so an edited source builds
anew and an unchanged one is loaded as it is. Nothing is built at
import: the first launch on a CUDA tensor (or ``load()``) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None
_functions: dict[str, ctypes._CFuncPtr] = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


def _build(target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR, prefix=".tmp_build_") as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        (BUILD_DIR / "nvcc.log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        so = Path(tmp) / target.name
        subprocess.run(
            [nvcc, "-shared", "-o", str(so), *(str(o) for _, o, _ in procs)],
            check=True, capture_output=True, text=True,
        )
        os.replace(so, target)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        target = library_path()
        if not target.is_file():
            _build(target)
        _lib = ctypes.CDLL(str(target))
        _lib.repro_error_string.argtypes = [ctypes.c_int]
        _lib.repro_error_string.restype = ctypes.c_char_p
    return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry of the library with its argument types declared (looked
    up once, then served from a cache on every launch)."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if err != 0:
        text = load().repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a C pointer (read
    raw: building a ``torch.cuda.Stream`` costs microseconds a launch)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.device.index))
