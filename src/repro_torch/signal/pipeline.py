"""Pipeline configuration (the twin of ``repro.signal.pipeline``'s
``PipelineConfig``, same fields, defaults and field order, so a program's
``cfg_json`` leaf parses into it and serializes back byte for byte).

``use_kernel`` is kept for checkpoint parity only: the port routes every
kernel by the device its tensors lie on. ``reference_kernels=True`` (the
JAX package's pre-megabatch bench leg) is not ported yet; the frontend
raises ``NotImplementedError`` for it.
"""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.core.rotation_forest import RotationForestConfig


class PipelineConfig(NamedTuple):
    wpd_level: int = 4
    wavelet: str = "db4"
    mspca_level: int = 5
    denoise: bool = True
    use_kernel: bool = False
    forest: RotationForestConfig = RotationForestConfig(
        n_trees=10, n_subsets=3, depth=6, n_classes=2, n_bins=32
    )
    # Alarm iff >= alarm_k of the last alarm_m chunks voted preictal.
    alarm_k: int = 3
    alarm_m: int = 5
    # Raw windows of the previous chunk prepended to each MSPCA matrix.
    overlap: int = 0
    reference_kernels: bool = False


def check_supported(cfg: PipelineConfig) -> None:
    """Raise for the config values this slice of the port does not run."""
    if cfg.reference_kernels:
        raise NotImplementedError(
            "PipelineConfig(reference_kernels=True) is not ported yet "
            "(ROADMAP.md queue 1, the reference_kernels bench leg of items "
            "2-4); use the default kernels"
        )
