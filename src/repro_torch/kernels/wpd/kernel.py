"""ctypes wrapper of K2, ``csrc/wpd_level.cu`` (replaces the Pallas
``repro/kernels/wpd/kernel.py::wpd_level``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0
MAX_ROW = 12288  # one row must fit 48 KB of shared memory
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
             ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, _P]


def wpd_level(
    x: torch.Tensor, h: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (R, N) contiguous float32 on a CUDA device; h, g (taps,) filter
    taps (any device; read on the host) -> (a, d), each (R, N/2)."""
    global LAUNCHES
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(
            f"wpd_level kernel takes a 2-D float32 CUDA tensor, got "
            f"{tuple(x.shape)} {x.dtype} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError("wpd_level kernel takes contiguous rows")
    rows, n = x.shape
    taps = int(h.shape[0])
    if n % 2 or n > MAX_ROW or taps not in (2, 4, 6, 8) or g.shape != h.shape:
        raise ValueError(
            f"wpd_level kernel: row length {n} must be even and <= {MAX_ROW}, "
            f"taps {taps} one of 2/4/6/8 with h and g alike"
        )
    a = torch.empty((rows, n // 2), dtype=torch.float32, device=x.device)
    d = torch.empty_like(a)
    if rows == 0:
        return a, d
    hc = (ctypes.c_float * taps)(*h.tolist())
    gc = (ctypes.c_float * taps)(*g.tolist())
    fn = build.function("repro_wpd_level", _ARGTYPES)
    build.check(
        fn(x.data_ptr(), a.data_ptr(), d.data_ptr(), rows, n, hc, gc, taps,
           x.device.index, build.stream_of(x)),
        "wpd_level",
    )
    LAUNCHES += 1
    return a, d
