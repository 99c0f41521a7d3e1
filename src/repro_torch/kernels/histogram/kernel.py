"""ctypes wrappers of K4, ``csrc/histogram.cu`` (replaces the Pallas
``repro/kernels/histogram/kernel.py::class_histogram``): two modes of one
kernel, each launch counted once in ``LAUNCHES``."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0
MAX_GRID_YZ = 65535  # trees (grid y) and bucket slices (grid z)
MAX_CLASSES = 256
_P = ctypes.c_void_p
_I = ctypes.c_int
_LEVEL_ARGTYPES = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_CLASS_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
CODE_TYPES = (torch.uint8, torch.int32)


def _check(name: str, t: torch.Tensor, dtypes: tuple, dim: int) -> None:
    if not t.is_cuda or t.dtype not in dtypes or not t.is_contiguous() or t.dim() != dim:
        raise ValueError(
            f"histogram kernel: {name} must be a contiguous {dim}-D CUDA tensor of "
            f"{' or '.join(map(str, dtypes))}, got {tuple(t.shape)} {t.dtype} on {t.device}"
        )


def _launch(fn_name: str, argtypes: list, args: tuple, like: torch.Tensor) -> None:
    global LAUNCHES
    fn = build.function(fn_name, argtypes)
    build.check(fn(*args, like.device.index, build.stream_of(like)), fn_name)
    LAUNCHES += 1


def level_histogram(
    codes: torch.Tensor,
    local: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    *,
    nodes_at: int,
    n_bins: int,
    n_classes: int,
) -> torch.Tensor:
    """One grower level's histogram, the bucket ids computed in the kernel.

    codes : (T, F, N) contiguous uint8 or int32 bin codes, feature-major.
    local : (T, N) contiguous int32 node-local ids.
    y     : (N,) int32 labels.   w : (T, N) contiguous float32 weights.
    All on one CUDA device. Returns (T, F, nodes_at * n_bins, C) float32:
    sample n adds w[t, n] at bucket local[t, n] * n_bins + codes[t, f, n]
    and class y[n]; a bucket outside the range or a label outside
    ``[0, C)`` adds nothing.

    Shared-memory atomics sum in an order that changes from run to run:
    for the grower's 0/1 weights every partial sum is an integer below
    2**24 and the result is exact; for float weights it agrees with an
    ordered sum to float32 rounding, ~1e-6 relative per bucket."""
    _check("codes", codes, CODE_TYPES, 3)
    _check("local", local, (torch.int32,), 2)
    _check("y", y, (torch.int32,), 1)
    _check("w", w, (torch.float32,), 2)
    t, f, n = codes.shape
    n_buckets = nodes_at * n_bins
    dev = codes.device
    if (local.shape != (t, n) or w.shape != (t, n) or y.shape != (n,) or n_bins < 1
            or nodes_at < 1 or not 1 <= n_classes <= MAX_CLASSES or t > MAX_GRID_YZ
            or local.device != dev or y.device != dev or w.device != dev):
        raise ValueError(
            f"histogram kernel: codes {tuple(codes.shape)}, local {tuple(local.shape)}, "
            f"y {tuple(y.shape)}, w {tuple(w.shape)} need (T, N) and (N,) to match codes "
            f"(T, F, N) on one device, T <= {MAX_GRID_YZ}, 1 <= C <= {MAX_CLASSES}"
        )
    out = torch.empty((t, f, n_buckets, n_classes), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if n == 0:
        return out.zero_()
    _launch("repro_level_histogram", _LEVEL_ARGTYPES,
            (codes.data_ptr(), codes.element_size(), local.data_ptr(), y.data_ptr(),
             w.data_ptr(), out.data_ptr(), t, n, f, n_classes, n_bins, n_buckets), codes)
    return out


def class_histogram(codes: torch.Tensor, wy: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """The TPU kernel's contract: codes (T, N, F) contiguous int32, wy (T, N,
    C) contiguous float32, both on one CUDA device -> (T, F, n_buckets, C)
    float32; codes outside ``[0, n_buckets)`` are skipped. A histogram
    larger than one block's shared memory is built in bucket slices, one
    block per slice. Summed in shared-memory atomics, exact on 0/1 masses
    as ``level_histogram``."""
    _check("codes", codes, (torch.int32,), 3)
    _check("wy", wy, (torch.float32,), 3)
    t, n, f = codes.shape
    c = wy.shape[-1]
    if (wy.shape[:2] != (t, n) or wy.device != codes.device or n_buckets < 1
            or not 1 <= c <= MAX_CLASSES or t > MAX_GRID_YZ):
        raise ValueError(
            f"histogram kernel: codes {tuple(codes.shape)}, wy {tuple(wy.shape)}, "
            f"n_buckets {n_buckets} need matching (T, N) on one device, T <= "
            f"{MAX_GRID_YZ} and 1 <= C <= {MAX_CLASSES}"
        )
    out = torch.empty((t, f, n_buckets, c), dtype=torch.float32, device=codes.device)
    if out.numel() == 0:
        return out
    if n == 0:
        return out.zero_()
    _launch("repro_class_histogram", _CLASS_ARGTYPES,
            (codes.data_ptr(), wy.data_ptr(), out.data_ptr(), t, n, f, c, n_buckets), codes)
    return out
