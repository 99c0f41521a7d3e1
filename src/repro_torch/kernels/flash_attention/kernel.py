"""ctypes wrapper of K5, ``csrc/flash_attention.cu`` (replaces the Pallas
``repro/kernels/flash_attention/kernel.py::flash_attention``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0
HEAD_DIMS = (64, 128)
MAX_BH = 65535  # grid y
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_TYPES = {torch.bfloat16: 1, torch.float32: 0}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v: contiguous (BH, S, hd) of one type (bfloat16 or float32)
    on one CUDA device, hd 64 or 128 -> (BH, S, hd) of that type: online
    softmax attention with scale 1/sqrt(hd), causal or not."""
    global LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype not in _TYPES or not t.is_contiguous():
            raise ValueError(
                f"flash_attention kernel: {name} must be contiguous bfloat16 or "
                f"float32 on CUDA, got {t.dtype} on {t.device}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} must start on a 16-byte boundary")
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(
                f"flash_attention kernel: {name} {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, q {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    if q.dim() != 3:
        raise ValueError(f"flash_attention kernel: q must be (BH, S, hd), got {tuple(q.shape)}")
    bh, s, hd = q.shape
    if hd not in HEAD_DIMS or not 0 < bh <= MAX_BH or s == 0:
        raise ValueError(
            f"flash_attention kernel: takes hd in {HEAD_DIMS}, 0 < BH <= {MAX_BH} "
            f"and S > 0, got {tuple(q.shape)}"
        )
    out = torch.empty_like(q)
    fn = build.function("repro_flash_attention", _ARGTYPES)
    build.check(
        fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, hd,
           int(causal), _TYPES[q.dtype], q.device.index, build.stream_of(q)),
        "flash_attention",
    )
    LAUNCHES += 1
    return out
