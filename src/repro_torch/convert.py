"""Carry a scoring program between the JAX reference and the port.

The two packages share one checkpoint layout, so a program crosses as
the flat dict ``repro.serving.api.ScoringProgram._to_arrays()`` returns:
float32 ``proj`` / ``thr`` / ``leaf_probs`` / ``feat_mean`` /
``feat_std`` and the config as a uint8 JSON ``cfg_json`` leaf. Both
directions are numpy-only, so neither package imports the other.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serving.api import ScoringProgram


def program_from_jax_arrays(
    arrays: dict[str, np.ndarray], device: torch.device | str | None = None
) -> ScoringProgram:
    """The port's ``ScoringProgram`` from the reference's ``_to_arrays()``
    dict, on ``device`` (CUDA by default)."""
    return ScoringProgram._from_arrays(dict(arrays), resolve_device(device))


def program_to_jax_arrays(program: ScoringProgram) -> dict[str, np.ndarray]:
    """Inverse of ``program_from_jax_arrays``: the dict the reference's
    ``ScoringProgram._from_arrays`` takes."""
    return program._to_arrays()
