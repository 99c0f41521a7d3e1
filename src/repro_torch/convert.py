"""Carry scoring programs and trained forests between the JAX reference
and the port.

The two packages share one checkpoint layout, so a program crosses as
the flat dict ``repro.serving.api.ScoringProgram._to_arrays()`` returns:
float32 ``proj`` / ``thr`` / ``leaf_probs`` / ``feat_mean`` /
``feat_std`` and the config as a uint8 JSON ``cfg_json`` leaf.

A trained forest (``RotationForestParams``) or pipeline
(``FittedPipeline``) crosses as a flat dict of numpy arrays named after
its fields: ``rotation``, the four ``TreeParams`` fields, and for a
pipeline ``feat_mean`` / ``feat_std``. ``*_from_jax`` read the
reference's named tuples structurally (``numpy.asarray`` of each field),
and ``*_to_arrays`` give the dict the reference's tuples are built from.
An LM parameter tree (the reference's nested dict from ``Model.init``)
crosses as a state dict keyed by its paths joined with ``.``
(``lm_params_from_jax``), which ``repro_torch.models.Model.load_params``
takes.

Every direction is numpy-only, so neither package imports the other.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import decision_tree as dt
from repro_torch.core import rotation_forest as rf
from repro_torch.device import resolve_device
from repro_torch.models import params as lm_params
from repro_torch.serving.api import ScoringProgram
from repro_torch.signal.pipeline import FittedPipeline

_INTS = ("split_feature", "split_bin")


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


def forest_from_arrays(
    arrays: dict[str, np.ndarray], device: torch.device | str | None = None
) -> rf.RotationForestParams:
    """The port's ``RotationForestParams`` from the flat numpy dict, on
    ``device`` (CUDA by default)."""
    dev = resolve_device(device)

    def leaf(k):
        dtype = np.int32 if k in _INTS else np.float32
        return torch.from_numpy(np.array(arrays[k], dtype=dtype)).to(dev)

    return rf.RotationForestParams(
        rotation=leaf("rotation"), trees=dt.TreeParams(*(leaf(k) for k in dt.TreeParams._fields))
    )


def forest_to_arrays(params: rf.RotationForestParams) -> dict[str, np.ndarray]:
    """Inverse of ``forest_from_arrays``."""
    out = {"rotation": params.rotation.detach().cpu().numpy()}
    out.update({k: v.detach().cpu().numpy() for k, v in params.trees._asdict().items()})
    return out


def _jax_forest_arrays(params) -> dict[str, np.ndarray]:
    arrays = {"rotation": np.asarray(params.rotation)}
    arrays.update({k: np.asarray(getattr(params.trees, k)) for k in dt.TreeParams._fields})
    return arrays


def forest_from_jax(params, device: torch.device | str | None = None) -> rf.RotationForestParams:
    """The reference's ``RotationForestParams`` (read field by field with
    ``numpy.asarray``) as the port's."""
    return forest_from_arrays(_jax_forest_arrays(params), device)


def fitted_from_arrays(
    arrays: dict[str, np.ndarray], device: torch.device | str | None = None
) -> FittedPipeline:
    """The port's ``FittedPipeline`` from the flat numpy dict."""
    dev = resolve_device(device)
    stats = (torch.from_numpy(np.array(arrays[k], dtype=np.float32)).to(dev)
             for k in ("feat_mean", "feat_std"))
    return FittedPipeline(forest_from_arrays(arrays, dev), *stats)


def fitted_to_arrays(fitted: FittedPipeline) -> dict[str, np.ndarray]:
    """Inverse of ``fitted_from_arrays``."""
    out = forest_to_arrays(fitted.forest)
    out["feat_mean"] = fitted.feat_mean.detach().cpu().numpy()
    out["feat_std"] = fitted.feat_std.detach().cpu().numpy()
    return out


def fitted_from_jax(fitted, device: torch.device | str | None = None) -> FittedPipeline:
    """The reference's ``FittedPipeline`` as the port's."""
    arrays = _jax_forest_arrays(fitted.forest)
    arrays.update(feat_mean=np.asarray(fitted.feat_mean), feat_std=np.asarray(fitted.feat_std))
    return fitted_from_arrays(arrays, device)


def lm_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The reference's LM parameter tree (nested dicts of arrays, read
    with ``numpy.asarray``) as the port's state dict: float32 CPU tensors
    keyed by the dotted path."""
    return {
        ".".join(path): torch.from_numpy(np.array(leaf, dtype=np.float32))
        for path, leaf in lm_params.flatten(tree)
    }
