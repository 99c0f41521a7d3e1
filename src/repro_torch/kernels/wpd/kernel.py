"""ctypes wrapper of K2, ``csrc/wpd_level.cu`` (replaces the Pallas
``repro/kernels/wpd/kernel.py::wpd_level``).

One kernel, three entries: ``wpd_level`` (the TPU kernel's single level),
``wpd_tree`` (a whole packet tree) and ``dwt_levels`` (a whole DWT), each
one launch that reads x once and writes only the coefficients it returns.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0
MAX_ROW = 12288  # two 48 KB shared-memory buffers
MAX_LEVELS = 16
ALIGN = 64  # floats: each DWT scale starts 256-byte aligned in the one output
TREE, CHAIN = 0, 1  # the kernel's modes
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _I, _P]


def _host_taps(f: torch.Tensor) -> torch.Tensor:
    """Filter taps as a contiguous float32 CPU tensor (``wavelet.filters``
    gives them so, and they pass as they are); the launcher reads them on
    the host."""
    if f.device.type != "cpu" or f.dtype != torch.float32 or not f.is_contiguous():
        f = f.detach().to(device="cpu", dtype=torch.float32).contiguous()
    return f


def dwt_offsets(rows: int, n: int, level: int) -> list[int]:
    """Where each scale of a DWT of (rows, n) starts in the kernel's one
    output, in floats: D1 .. D_level, then A_level; each ALIGN-aligned."""
    offsets, at = [], 0
    for j in range(1, level + 2):
        offsets.append(at)
        at += -(-rows * (n >> min(j, level)) // ALIGN) * ALIGN
    return offsets + [at]  # the total last


def _rows(x: torch.Tensor, h: torch.Tensor, g: torch.Tensor, level: int,
          what: str) -> tuple[int, int]:
    """Check the operands; returns (rows, N) of x (..., N)."""
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() < 2:
        raise ValueError(
            f"{what} kernel takes float32 CUDA rows (..., N), got "
            f"{tuple(x.shape)} {x.dtype} on {x.device}"
        )
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel takes contiguous rows")
    n = x.shape[-1]
    taps = int(h.shape[0])
    if (
        not 1 <= level <= MAX_LEVELS or n % (1 << level) or n > MAX_ROW
        or taps not in (2, 4, 6, 8) or g.shape != h.shape
    ):
        raise ValueError(
            f"{what} kernel: row length {n} must be a multiple of 2**{level} and "
            f"<= {MAX_ROW}, 1 <= level <= {MAX_LEVELS}, taps {taps} one of 2/4/6/8 "
            "with h and g alike"
        )
    return (x.numel() // n if n else 0), n


def _launch(x: torch.Tensor, out: torch.Tensor, rows: int, n: int, h: torch.Tensor,
            g: torch.Tensor, level: int, mode: int, offsets: list[int] | None,
            what: str) -> None:
    """Launch on checked operands: CHAIN writes D_{j+1} at offsets[j] and
    A_level at offsets[level] of out, TREE the last level's nodes."""
    global LAUNCHES
    if rows == 0:
        return
    hc, gc = _host_taps(h), _host_taps(g)
    off = None if offsets is None else (ctypes.c_longlong * (level + 1))(*offsets)
    fn = build.function("repro_wpd_levels", _ARGTYPES)
    build.check(
        fn(x.data_ptr(), out.data_ptr(), rows, n, level, mode, hc.data_ptr(), gc.data_ptr(),
           int(h.shape[0]), None if off is None else ctypes.addressof(off), x.device.index,
           build.stream_of(x)),
        what,
    )
    LAUNCHES += 1


def _strides(shape: tuple[int, ...]) -> tuple[int, ...]:
    strides, step = [], 1
    for size in reversed(shape):
        strides.append(step)
        step *= size
    return tuple(reversed(strides))


def dwt_levels(
    x: torch.Tensor, h: torch.Tensor, g: torch.Tensor, level: int
) -> list[torch.Tensor]:
    """x (..., N) contiguous float32 rows on a CUDA device; h, g (taps,)
    filter taps (any device; read on the host) -> [D1 (..., N/2), ...,
    D_level, A_level], each its own contiguous tensor: views of one
    allocation, one op each (at a batch of one the host's time is the
    call's)."""
    rows, n = _rows(x, h, g, level, "dwt_levels")
    offsets = dwt_offsets(rows, n, level)
    out = torch.empty(offsets[-1], dtype=torch.float32, device=x.device)
    _launch(x, out, rows, n, h, g, level, CHAIN, offsets[:-1], "dwt_levels")
    lead = tuple(x.shape[:-1])
    views = []
    for j, at in enumerate(offsets[:-1], start=1):
        shape = lead + (n >> min(j, level),)
        views.append(out.as_strided(shape, _strides(shape), at))
    return views


def wpd_tree(x: torch.Tensor, h: torch.Tensor, g: torch.Tensor, level: int) -> torch.Tensor:
    """x (..., N) contiguous float32 rows on a CUDA device -> the packet
    tree's terminal nodes (..., 2**level, N / 2**level) in Paley order
    (node 2i is the low branch of node i)."""
    rows, n = _rows(x, h, g, level, "wpd_tree")
    out = torch.empty(x.shape[:-1] + (1 << level, n >> level), dtype=torch.float32,
                      device=x.device)
    _launch(x, out, rows, n, h, g, level, TREE, None, "wpd_tree")
    return out


def wpd_level(
    x: torch.Tensor, h: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., N) contiguous float32 rows on a CUDA device; h, g (taps,)
    filter taps (any device; read on the host) -> (a, d), each (...,
    N/2): the TPU kernel's single level, a one-level DWT into one (2, ...,
    N/2) allocation, d first (no aligned offsets or views per scale: at a
    batch of one the host's time is the call's)."""
    rows, n = _rows(x, h, g, 1, "wpd_level")
    out = torch.empty((2,) + tuple(x.shape[:-1]) + (n // 2,), dtype=torch.float32,
                      device=x.device)
    _launch(x, out, rows, n, h, g, 1, CHAIN, [0, rows * (n // 2)], "wpd_level")
    d, a = out.unbind(0)
    return a, d
