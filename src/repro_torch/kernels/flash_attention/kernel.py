"""ctypes wrapper of K5, ``csrc/flash_attention.cu`` (replaces the Pallas
``repro/kernels/flash_attention/kernel.py::flash_attention``).

The kernel reads q (B, S, H, hd) and k, v (B, S, KV, hd) in place, through
4-D TMA tensor maps (dims hd, heads, S, B) whose parameters
``tensor_maps`` computes here; head h reads KV head h // (H // KV).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0
HEAD_DIMS = (64, 128)
BLOCK_Q = 128    # q rows per CTA (TMA box rows of q)
BLOCK_K = 128    # keys per k tile (TMA box rows of k and v)
BOX_COLS = 64    # columns per TMA box: 128 bytes of bf16, the swizzle width
_MAP = ctypes.c_ulonglong * 11
_P = ctypes.c_void_p
_I = ctypes.c_int
_Q = ctypes.POINTER(ctypes.c_ulonglong)
_ARGTYPES = [_P, _P, _P, _P, _Q, _Q, _Q, _I, _I, _I, _P]
_TYPES = {torch.bfloat16: 1, torch.float32: 0}


def tensor_map(t: torch.Tensor, rows: int) -> tuple[tuple, tuple, tuple]:
    """(dims, byte strides, box) of the TMA map over t (B, S, heads, hd):
    dims innermost first (hd, heads, S, B), the byte strides of heads, S
    and B, and the box of ``rows`` rows of one head of one batch, 64
    columns wide. Raises ValueError where a map cannot describe t: the last
    dimension not contiguous, or a stride that is not a multiple of 16
    bytes."""
    b, s, h, hd = t.shape
    e = t.element_size()
    if t.stride(3) != 1:
        raise ValueError(f"flash_attention kernel: the last dimension must be contiguous, "
                         f"got strides {t.stride()}")
    strides = (t.stride(2) * e, t.stride(1) * e, t.stride(0) * e)
    if any(st % 16 for st in strides):
        raise ValueError(f"flash_attention kernel: strides {t.stride()} of {tuple(t.shape)} "
                         f"{t.dtype} are not multiples of 16 bytes")
    return (hd, h, s, b), strides, (BOX_COLS, 1, rows, 1)


def tensor_maps(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    """The maps the kernel's TMA loads use, and which KV head each q head
    reads. Reads shapes and strides only (meta tensors do)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or t.dtype not in _TYPES or t.dtype != q.dtype:
            raise ValueError(
                f"flash_attention kernel: {name} must be a 4-D bfloat16 or float32 tensor of "
                f"q's type, got {tuple(t.shape)} {t.dtype} (q {q.dtype})"
            )
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if (k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd or kv == 0
            or h % kv):
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} takes k, v (B, S, KV, hd) "
                         f"with H % KV == 0, got {tuple(k.shape)}, {tuple(v.shape)}")
    if hd not in HEAD_DIMS or b == 0 or s == 0:
        raise ValueError(f"flash_attention kernel: takes hd in {HEAD_DIMS}, B > 0 and S > 0, "
                         f"got {tuple(q.shape)}")
    return {"q": tensor_map(q, BLOCK_Q), "k": tensor_map(k, BLOCK_K),
            "v": tensor_map(v, BLOCK_K), "kv_head": tuple(i // (h // kv) for i in range(h))}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, S, H, hd), k, v (B, S, KV, hd) of one type (bfloat16 or
    float32) on one CUDA device, hd 64 or 128, H % KV == 0, last dimension
    contiguous, other strides multiples of 16 bytes, 16-byte aligned ->
    (B, S, H, hd) contiguous of that type: online softmax attention with
    scale 1/sqrt(hd), causal or not, each q head reading its KV group."""
    global LAUNCHES
    maps = tensor_maps(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention kernel: {name} must be on q's CUDA device, "
                             f"got {t.device} (q on {q.device})")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} must start on a 16-byte boundary")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = build.function("repro_flash_attention", _ARGTYPES)
    q_map, k_map, v_map = (_MAP(*dims, *strides, *box) for dims, strides, box in
                           (maps["q"], maps["k"], maps["v"]))
    build.check(
        fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q_map, k_map, v_map,
           int(causal), _TYPES[q.dtype], q.device.index, build.stream_of(q)),
        "flash_attention",
    )
    LAUNCHES += 1
    return out
