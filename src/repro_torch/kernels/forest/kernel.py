"""ctypes wrapper of K1, ``csrc/forest.cu`` (replaces the Pallas
``repro/kernels/forest/kernel.py::forest_traverse``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0
ROWS_PER_BLOCK = 32
MAX_CLASSES = 8
MAX_SMEM = 232448  # bytes of shared memory one block may opt in to
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]


def forest_traverse(
    x: torch.Tensor, proj: torch.Tensor, thr: torch.Tensor, leaf_probs: torch.Tensor
) -> torch.Tensor:
    """x (B, F), proj (T, F, L), thr (T, L), leaf_probs (T, L, C): all
    contiguous float32 on one CUDA device -> (B, C) leaf probabilities
    summed over trees in ascending order."""
    global LAUNCHES
    tensors = {"x": x, "proj": proj, "thr": thr, "leaf_probs": leaf_probs}
    for name, t in tensors.items():
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"forest kernel: {name} must be contiguous float32 on CUDA, "
                f"got {t.dtype} on {t.device}"
            )
        if t.device != x.device:
            raise ValueError(f"forest kernel: {name} on {t.device}, x on {x.device}")
    b, f = x.shape
    n_trees, f_p, n_leaves = proj.shape
    n_classes = leaf_probs.shape[-1]
    depth = n_leaves.bit_length() - 1
    smem = 4 * (f * n_leaves + ROWS_PER_BLOCK * (f + n_leaves))
    if (
        f_p != f or thr.shape != (n_trees, n_leaves)
        or leaf_probs.shape != (n_trees, n_leaves, n_classes)
        or (1 << depth) != n_leaves or not 0 < n_classes <= MAX_CLASSES
        or smem > MAX_SMEM
    ):
        raise ValueError(
            f"forest kernel: shapes x {tuple(x.shape)}, proj {tuple(proj.shape)}, "
            f"thr {tuple(thr.shape)}, leaf_probs {tuple(leaf_probs.shape)} need "
            f"L a power of 2, C <= {MAX_CLASSES} and {smem} <= {MAX_SMEM} bytes "
            "of shared memory"
        )
    out = torch.empty((b, n_classes), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    fn = build.function("repro_forest_traverse", _ARGTYPES)
    build.check(
        fn(x.data_ptr(), proj.data_ptr(), thr.data_ptr(), leaf_probs.data_ptr(),
           out.data_ptr(), b, f, n_trees, n_leaves, n_classes, depth,
           x.device.index, build.stream_of(x)),
        "forest_traverse",
    )
    LAUNCHES += 1
    return out
