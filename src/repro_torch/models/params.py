"""Parameter spec trees (twin of the JAX package's ``models/params.py``).

Models declare their parameters once as a nested dict of ``ParamSpec``
and get from it:

  * ``init_params(specs, generator, device)`` -- materialized float32
    tensors, drawn leaf by leaf in sorted-path order from one
    ``torch.Generator``, with the reference's laws: ``normal`` is
    N(0, 1) x 1/sqrt(fan_in) (or the spec's scale; embed uses 1.0),
    ``small`` N(0, 1) x 0.02, ``ones`` and ``zeros`` constant;
  * ``param_count(specs)``;
  * the path structure (``flatten``) the model registers as its
    ``nn.Module`` tree, so a state dict key is the reference's path
    joined with ``.``.

All parameters are stored float32 (master copy); compute casts per
``ArchConfig.dtype``. The generator's numbers differ from ``jax.random``'s
for the same seed: the tests carry the reference's parameters across
(``convert.lm_params_from_jax``) instead of re-drawing them.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch


class ParamSpec(NamedTuple):
    shape: tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones | small
    scale: float | None = None  # None -> 1/sqrt(fan_in)


def dense(d_in: int, d_out: int, *stack: int) -> ParamSpec:
    return ParamSpec(tuple(stack) + (d_in, d_out), "normal", None)


def bias(d: int, *stack: int) -> ParamSpec:
    return ParamSpec(tuple(stack) + (d,), "zeros")


def norm_scale(d: int, *stack: int) -> ParamSpec:
    return ParamSpec(tuple(stack) + (d,), "ones")


def embed(v: int, d: int) -> ParamSpec:
    return ParamSpec((v, d), "normal", 1.0)


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def _fan_in(spec: ParamSpec) -> int:
    return spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]


def flatten(tree: dict, prefix: tuple[str, ...] = ()) -> list[tuple[tuple[str, ...], Any]]:
    """(path, leaf) pairs in sorted-key order (``jax.tree.flatten``'s
    order for dicts)."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out += flatten(value, prefix + (key,))
        else:
            out.append((prefix + (key,), value))
    return out


def unflatten(pairs) -> dict:
    """Inverse of ``flatten``."""
    tree: dict = {}
    for path, leaf in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def init_params(specs: dict, generator: torch.Generator, device: torch.device) -> dict:
    """Materialized float32 parameters on ``device``. Normal draws come
    from ``generator`` on its own device, one leaf after another."""

    def one(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=torch.float32, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=torch.float32, device=device)
        scale = spec.scale
        if scale is None:
            scale = 1.0 / math.sqrt(max(_fan_in(spec), 1))
        if spec.init == "small":
            scale = 0.02
        draw = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                           device=generator.device)
        return (draw.mul_(scale)).to(device)

    return unflatten((path, one(spec)) for path, spec in flatten(specs))


def param_count(specs: dict) -> int:
    return int(sum(math.prod(s.shape) for _, s in flatten(specs)))
