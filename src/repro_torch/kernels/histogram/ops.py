"""K4 router: the class histogram the level-synchronous tree grower
(``core.decision_tree.fit_forest_binned``) builds once per level."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels._route import on_cuda
from repro_torch.kernels.histogram import kernel as _kernel
from repro_torch.kernels.histogram import ref as _ref


def class_histogram(codes: torch.Tensor, wy: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """codes (T, N, F) bucket ids (out-of-range ids ignored), wy (T, N, C)
    class mass -> (T, F, n_buckets, C) float32. A CUDA tensor goes through
    the kernel, a CPU tensor through the plain version."""
    if not on_cuda(codes, "class_histogram"):
        return _ref.class_histogram(codes, wy, n_buckets)
    return _kernel.class_histogram(
        codes.to(torch.int32).contiguous(), wy.to(torch.float32).contiguous(), n_buckets
    )


def level_histogram(
    xb: torch.Tensor,
    local: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    *,
    nodes_at: int,
    n_bins: int,
    n_classes: int,
) -> torch.Tensor:
    """One grower level's histogram over all trees at once.

    xb    : (T, N, F) int32 bin codes.
    local : (T, N) int32 node-local ids in [0, nodes_at).
    y     : (N,) integer labels shared by every tree.
    w     : (T, N) float32 per-tree sample weights.
    Returns (T, F, nodes_at * n_bins, C).
    """
    codes = local[:, :, None] * n_bins + xb
    wy = w[..., None] * F.one_hot(y.to(torch.int64), n_classes).to(torch.float32)
    return class_histogram(codes, wy, nodes_at * n_bins)
