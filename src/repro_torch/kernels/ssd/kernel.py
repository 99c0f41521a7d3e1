"""ctypes wrapper of K6, ``csrc/ssd_chunks.cu`` (replaces the Pallas
``repro/kernels/ssd/kernel.py::ssd_chunks``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0
HEAD_DIM = 64     # Dk = Dv
MAX_CHUNK = 256   # L
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _P]
_TYPES = {torch.bfloat16: 1, torch.float32: 0}


def ssd_chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
               h_in: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k, v: contiguous (BH, NC, L, 64) of one type (bfloat16 or
    float32), ld: contiguous (BH, NC, L) of that type, h_in: contiguous
    (BH, NC, 64, 64) float32, all on one CUDA device, 1 <= L <= 256.
    Returns (y (BH, NC, L, 64) of q's type, state_out (BH, NC, 64, 64)
    float32): the SSD step of every chunk, given the state entering it."""
    global LAUNCHES
    if q.dim() != 4:
        raise ValueError(f"ssd_chunks kernel: q must be (BH, NC, L, Dk), got {tuple(q.shape)}")
    bh, nc, l, dk = q.shape
    want = {"q": (q.shape, q.dtype), "k": (q.shape, q.dtype), "v": (q.shape, q.dtype),
            "ld": ((bh, nc, l), q.dtype), "h_in": ((bh, nc, dk, dk), torch.float32)}
    for name, t in (("q", q), ("k", k), ("v", v), ("ld", ld), ("h_in", h_in)):
        if not t.is_cuda or t.dtype not in _TYPES or not t.is_contiguous():
            raise ValueError(
                f"ssd_chunks kernel: {name} must be contiguous bfloat16 or float32 on "
                f"CUDA, got {t.dtype} on {t.device}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_chunks kernel: {name} must start on a 16-byte boundary")
        shape, dtype = want[name]
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != q.device:
            raise ValueError(
                f"ssd_chunks kernel: {name} {tuple(t.shape)} {t.dtype} on {t.device}, "
                f"expected {tuple(shape)} {dtype} on {q.device}"
            )
    if dk != HEAD_DIM or not 0 < l <= MAX_CHUNK or bh * nc == 0:
        raise ValueError(
            f"ssd_chunks kernel: takes Dk = Dv = {HEAD_DIM}, 0 < L <= {MAX_CHUNK} and "
            f"BH * NC > 0, got q {tuple(q.shape)}"
        )
    y = torch.empty_like(v)
    state = torch.empty_like(h_in)
    fn = build.function("repro_ssd_chunks", _ARGTYPES)
    build.check(
        fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ld.data_ptr(), h_in.data_ptr(),
           y.data_ptr(), state.data_ptr(), bh * nc, l, _TYPES[q.dtype], q.device.index,
           build.stream_of(q)),
        "ssd_chunks",
    )
    LAUNCHES += 1
    return y, state
