"""ctypes wrapper of K3, ``csrc/gram.cu`` (replaces the Pallas
``repro/kernels/gram/kernel.py::gram``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0
MAX_BATCH = 65535  # grid z
TILE = 64          # output tile edge
SLAB = 32          # samples per staged slab: a split is a whole number of slabs
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _I, _I, _I, _P]
_SMS: dict[int, int] = {}  # SM count per device index


def upper_tiles(p: int) -> int:
    """The 64 x 64 tiles of one G on or above the diagonal."""
    tiles = -(-p // TILE)
    return tiles * (tiles + 1) // 2


def split_plan(batch: int, n: int, p: int, sms: int) -> tuple[int, int]:
    """(n_split, chunk): the sample axis is cut into n_split ranges of chunk
    samples (whole 32-sample slabs). Under 8 slabs the reduce pass, a
    second launch, costs more than it saves: no split. With fewer blocks
    than SMs (a fit's batch of one) up to four blocks per SM, down to one
    slab each; otherwise up to two per SM, at least 4 slabs each. (Chosen from
    ``tools/gram_splits.py``, which times every split count at the path's
    shapes on the card.)"""
    slabs = -(-n // SLAB)
    base = batch * upper_tiles(p)
    if slabs < 8:
        n_split = 1
    elif base < sms:
        n_split = min(slabs, -(-4 * sms // base))
    else:
        n_split = max(1, min(slabs // 4, -(-2 * sms // base)))
    chunk = -(-slabs // n_split) * SLAB
    return -(-n // chunk), chunk


def load_mode(x: torch.Tensor) -> int:
    """How the kernel stages x (batch, n, p): 0 in 16-byte copies along
    the samples (sn = 1, every variable's row on 16 bytes: pca.fit_T's
    transposed view), 1 along the variables (sp = 1, every sample's row on
    16 bytes), 2 in 4-byte copies at any strides."""
    batch, n, p = x.shape
    sb, sn, sp = x.stride()
    aligned = x.data_ptr() % 16 == 0 and (batch == 1 or sb % 4 == 0)
    if aligned and sn == 1 and (p == 1 or sp % 4 == 0):
        return 0
    if aligned and sp == 1 and (n == 1 or sn % 4 == 0):
        return 1
    return 2


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
    dev = x.device.index
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty((batch, p, p), dtype=torch.float32, device=x.device)
    n_split, chunk = split_plan(batch, n, p, sms)
    partial = None
    if n_split > 1:
        partial = torch.empty((batch, n_split, upper_tiles(p), TILE, TILE),
                              dtype=torch.float32, device=x.device)
    sb, sn, sp = x.stride()
    fn = build.function("repro_gram", _ARGTYPES)
    build.check(
        fn(x.data_ptr(), out.data_ptr(), None if partial is None else partial.data_ptr(),
           batch, n, p, sb, sn, sp, n_split, chunk, load_mode(x), dev, build.stream_of(x)),
        "gram",
    )
    LAUNCHES += 1
    return out
