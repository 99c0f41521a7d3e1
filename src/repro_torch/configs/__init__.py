"""Config registry: ``get_config("<arch-id>")`` -> ArchConfig.

Arch ids are the JAX package's names; each module cites its source. Only
the dense family runs in the port so far (``models.model.Model`` raises
for the others).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    INPUT_SHAPES,
    ArchConfig,
    InputShape,
    shape_applicable,
)

_MODULES = {
    "zamba2-7b": "zamba2_7b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen3-0.6b": "qwen3_0_6b",
    "command-r-35b": "command_r_35b",
    "paligemma-3b": "paligemma_3b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "starcoder2-7b": "starcoder2_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "xlstm-1.3b": "xlstm_1_3b",
}

ARCH_NAMES = tuple(_MODULES)

# Beyond the assignment: extra public-literature configs exercising the
# same families (selectable via get_config / --arch in train.py; NOT part
# of the assigned 40-pair dry-run table).
_BONUS_MODULES = {
    "llama3-8b": "llama3_8b",
    "mixtral-8x7b": "mixtral_8x7b",
}
BONUS_ARCH_NAMES = tuple(_BONUS_MODULES)
_MODULES = {**_MODULES, **_BONUS_MODULES}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


__all__ = [
    "ARCH_NAMES",
    "ArchConfig",
    "InputShape",
    "INPUT_SHAPES",
    "get_config",
    "shape_applicable",
]
