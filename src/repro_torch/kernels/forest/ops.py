"""Public fused rotation-forest inference over a packed forest (K1)."""

from __future__ import annotations

from typing import NamedTuple

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
