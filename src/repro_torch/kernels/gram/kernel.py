"""ctypes wrapper of K3, ``csrc/gram.cu`` (replaces the Pallas
``repro/kernels/gram/kernel.py::gram``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0
MAX_BATCH = 65535  # grid z
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _I, _I, _I, _L, _L, _L, _I, _P]


def gram(x: torch.Tensor) -> torch.Tensor:
    """x (batch, n, p) float32 on a CUDA device, at any element strides
    (a transposed (batch, p, n) block is read in place) ->
    (batch, p, p) contiguous, G[b] = x[b]^T x[b]."""
    global LAUNCHES
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(
            f"gram kernel takes a 3-D float32 CUDA tensor, got "
            f"{tuple(x.shape)} {x.dtype} on {x.device}"
        )
    batch, n, p = x.shape
    if batch > MAX_BATCH:
        raise ValueError(f"gram kernel: batch {batch} > {MAX_BATCH}")
    if batch == 0 or n == 0 or p == 0:
        return torch.zeros((batch, p, p), dtype=torch.float32, device=x.device)
    out = torch.empty((batch, p, p), dtype=torch.float32, device=x.device)
    sb, sn, sp = x.stride()
    fn = build.function("repro_gram", _ARGTYPES)
    build.check(
        fn(x.data_ptr(), out.data_ptr(), batch, n, p, sb, sn, sp,
           x.device.index, build.stream_of(x)),
        "gram",
    )
    LAUNCHES += 1
    return out
