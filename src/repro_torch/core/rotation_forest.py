"""Rotation-forest configuration (the twin of ``repro.core.rotation_forest``'s
``RotationForestConfig``, same fields and defaults).

Only the config is ported in this slice: serving consumes an already
packed forest (``kernels.forest.ops.PackedForest``), and fitting one is
the training slice's work.
"""

from __future__ import annotations

from typing import NamedTuple


class RotationForestConfig(NamedTuple):
    n_trees: int = 10
    n_subsets: int = 3          # K in the paper
    depth: int = 6
    n_classes: int = 2
    n_bins: int = 32
    bootstrap_frac: float = 0.75
    min_samples: int = 2
    use_hist_kernel: bool = False
