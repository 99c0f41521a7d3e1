"""K4 router: the class histogram the level-synchronous tree grower
(``core.decision_tree.fit_forest_binned``) builds once per level.

A CUDA tensor goes through the kernel, a CPU tensor through the plain
version. ``level_histogram`` takes the grower's own inputs, with the bin
codes feature-major in the narrowest type (``feature_major``, once per
fit): the kernel computes each bucket id itself, so no level rebuilds a
(T, N, F) codes tensor. ``class_histogram`` is the TPU kernel's contract.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._route import on_cuda
from repro_torch.kernels.histogram import kernel as _kernel
from repro_torch.kernels.histogram import ref as _ref


def class_histogram(codes: torch.Tensor, wy: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """codes (T, N, F) bucket ids (out-of-range ids ignored), wy (T, N, C)
    class mass -> (T, F, n_buckets, C) float32."""
    if not on_cuda(codes, "class_histogram"):
        return _ref.class_histogram(codes, wy, n_buckets)
    return _kernel.class_histogram(
        codes.to(torch.int32).contiguous(), wy.to(torch.float32).contiguous(), n_buckets
    )


def feature_major(xb: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(T, N, F) bin codes in [0, n_bins) -> contiguous (T, F, N) codes in
    the narrowest type the kernel takes: uint8 up to 256 bins, else int32."""
    dtype = torch.uint8 if n_bins <= 256 else torch.int32
    return xb.transpose(1, 2).to(dtype).contiguous()


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
    """One grower level's histogram over all trees at once.

    codes : (T, F, N) bin codes, feature-major (``feature_major``).
    local : (T, N) int32 node-local ids in [0, nodes_at).
    y     : (N,) int32 labels shared by every tree.
    w     : (T, N) float32 per-tree sample weights.
    Returns (T, F, nodes_at * n_bins, C): the reference's
    ``level_histogram`` of the (T, N, F) codes. On a CUDA tensor every
    input must already have the kernel's type and be contiguous (the
    grower's do; the wrapper raises otherwise).
    """
    if not on_cuda(codes, "level_histogram"):
        return _ref.level_histogram(codes, local, y, w, nodes_at=nodes_at, n_bins=n_bins,
                                    n_classes=n_classes)
    return _kernel.level_histogram(codes, local, y, w, nodes_at=nodes_at, n_bins=n_bins,
                                   n_classes=n_classes)
