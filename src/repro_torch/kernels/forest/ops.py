"""Public fused rotation-forest inference over a packed forest (K1):
``pack_forest`` lowers a fitted forest into the dense tensors of ref.py
once, ``forest_predict_proba`` traverses a batch through them.

This module imports nothing of ``repro_torch.core`` (the core imports
it); ``pack_forest`` reads the fitted params structurally.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels._route import on_cuda
from repro_torch.kernels.forest import kernel as _kernel
from repro_torch.kernels.forest import ref as _ref


class PackedForest(NamedTuple):
    """Dense inference-only forest (leading axis = tree); see ref.py."""

    proj: torch.Tensor        # (T, F, L)
    thr: torch.Tensor         # (T, L), +inf = dead node
    leaf_probs: torch.Tensor  # (T, L, C)

    @property
    def n_trees(self) -> int:
        return self.proj.shape[0]

    @property
    def n_features(self) -> int:
        return self.proj.shape[1]


def pack_forest(params: Any) -> PackedForest:
    """A fitted forest -> ``PackedForest``, by exact gathers.

    ``params`` has ``.rotation`` (T, F, F) and ``.trees`` with
    ``split_feature`` (T, L), ``split_bin`` (T, L), ``leaf_probs``
    (T, L, C) and ``bin_edges`` (T, F, E). Node i's column of ``proj`` is
    the rotation column of its split feature, and its ``thr`` is the bin
    edge of its split: going right in bin space (code > split_bin, codes
    binned side left) is exactly going right in raw space (value > edge).
    A dead node (no split: feature -1, bin = n_bins) gets ``thr = +inf``
    and always routes left.
    """
    rot = params.rotation.to(torch.float32)
    feat = params.trees.split_feature
    sbin = params.trees.split_bin
    edges = params.trees.bin_edges.to(torch.float32)
    n_feat, n_edges = rot.shape[-1], edges.shape[-1]

    safe_feat = feat.clamp(0, n_feat - 1).to(torch.int64)
    proj = torch.gather(rot, 2, safe_feat[:, None, :].expand(-1, rot.shape[1], -1))
    safe_bin = sbin.clamp(0, n_edges - 1).to(torch.int64)
    edges_at_feat = torch.gather(edges, 1, safe_feat[:, :, None].expand(-1, -1, n_edges))
    thr = torch.gather(edges_at_feat, 2, safe_bin[:, :, None])[..., 0]
    dead = (feat < 0) | (sbin >= n_edges)
    thr = torch.where(dead, torch.inf, thr)
    return PackedForest(
        proj=proj.contiguous(), thr=thr.contiguous(),
        leaf_probs=params.trees.leaf_probs.to(torch.float32).contiguous(),
    )


def forest_predict_proba(packed: PackedForest, x: torch.Tensor) -> torch.Tensor:
    """(B, F') raw features -> (B, C) ensemble-MEAN class probabilities.
    x is right-padded with zeros to the forest's F (a forest fit on
    features padded to a multiple of its subset count). A CUDA tensor goes
    through the kernel, a CPU tensor through the plain version."""
    x = x.to(torch.float32)
    f = packed.n_features
    if x.shape[1] < f:
        x = F.pad(x, (0, f - x.shape[1]))
    if on_cuda(x, "forest_predict_proba"):
        total = _kernel.forest_traverse(
            x.contiguous(), packed.proj, packed.thr, packed.leaf_probs
        )
    else:
        total = _ref.forest_traverse(x, packed.proj, packed.thr, packed.leaf_probs)
    return total / packed.n_trees
