"""ctypes wrapper of K4, ``csrc/histogram.cu`` (replaces the Pallas
``repro/kernels/histogram/kernel.py::class_histogram``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0
MAX_SMEM = 232448  # bytes of shared memory one block may opt in to
MAX_GRID_YZ = 65535  # trees (grid y) and bucket slices (grid z)
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def class_histogram(codes: torch.Tensor, wy: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """codes (T, N, F) contiguous int32, wy (T, N, C) contiguous float32,
    both on one CUDA device -> (T, F, n_buckets, C) float32; codes outside
    ``[0, n_buckets)`` are skipped. A histogram larger than one block's
    shared memory is built in bucket slices, one block per slice.

    The samples of one (tree, feature) are summed with shared-memory
    atomics, in an order that changes from run to run. Where every partial
    sum is an integer below 2**24 (the grower's 0/1 bootstrap masses) the
    result is exact, equal bit for bit to any other summation order; for
    general float weights it agrees with an ordered sum to float32
    rounding, ~1e-6 relative per bucket."""
    global LAUNCHES
    for name, t, dtype in (("codes", codes, torch.int32), ("wy", wy, torch.float32)):
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous() or t.dim() != 3:
            raise ValueError(
                f"histogram kernel: {name} must be a contiguous 3-D {dtype} CUDA "
                f"tensor, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if wy.device != codes.device:
        raise ValueError(f"histogram kernel: wy on {wy.device}, codes on {codes.device}")
    t, n, f = codes.shape
    c = wy.shape[-1]
    slice_ = max(1, min(n_buckets, MAX_SMEM // (4 * max(c, 1))))
    if (wy.shape[:2] != (t, n) or n_buckets < 1 or not 1 <= 4 * c <= MAX_SMEM
            or t > MAX_GRID_YZ or -(-n_buckets // slice_) > MAX_GRID_YZ):
        raise ValueError(
            f"histogram kernel: codes {tuple(codes.shape)}, wy {tuple(wy.shape)}, "
            f"n_buckets {n_buckets} need matching (T, N), T <= {MAX_GRID_YZ}, "
            f"4 * C <= {MAX_SMEM} and at most {MAX_GRID_YZ} bucket slices"
        )
    if t == 0 or f == 0 or n == 0:
        return torch.zeros((t, f, n_buckets, c), dtype=torch.float32, device=codes.device)
    out = torch.empty((t, f, n_buckets, c), dtype=torch.float32, device=codes.device)
    fn = build.function("repro_class_histogram", _ARGTYPES)
    build.check(
        fn(codes.data_ptr(), wy.data_ptr(), out.data_ptr(), t, n, f, c, n_buckets,
           codes.device.index, build.stream_of(codes)),
        "class_histogram",
    )
    LAUNCHES += 1
    return out
