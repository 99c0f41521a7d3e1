"""AdamW with global-norm clipping, decoupled weight decay and schedule
support (twin of the JAX package's ``optim/adamw.py``).

Trees are nested dicts of tensors (the model's parameter paths). The
moments m and v are float32. ``update`` returns the reference's
``(updates, state)`` pair, but writes m, v and the step counter IN PLACE:
the returned state holds the caller's tensors, so a state is stepped
once (copy it first, with ``training.trainer.clone_tree``, to step one
state twice).
``apply_updates`` adds in place likewise. Every value stays on the
device: the step, the clip scale and the learning rate are 0-dim tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models import params as pr
from repro_torch.models.model import TensorSpec


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: Any   # int32 0-dim tensor (or a (members,) stack of them)
    m: Any
    v: Any


class Optimizer(NamedTuple):
    init: Callable[[Any], AdamWState]
    update: Callable[[Any, AdamWState, Any], tuple[Any, AdamWState]]


def _map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the corresponding leaves of equally shaped trees."""
    flats = [pr.flatten(t) for t in trees]
    return pr.unflatten((path, fn(*(f[i][1] for f in flats)))
                        for i, (path, _) in enumerate(flats[0]))


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [t for _, t in pr.flatten(tree)]
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))


def adamw(cfg: AdamWConfig, schedule: Callable | None = None) -> Optimizer:
    sched = schedule or (lambda step: torch.full((), cfg.lr, dtype=torch.float32,
                                                  device=step.device))

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        dev = pr.flatten(params)[0][1].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          _map(zeros, params), _map(zeros, params))

    def update(grads, state, params):
        step = state.step.add_(1)
        gn = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
        sf = step.to(torch.float32)
        bc1 = 1 - cfg.b1 ** sf
        bc2 = 1 - cfg.b2 ** sf
        lr = sched(step)

        def upd(p, mm, vv, g):
            g = g.to(torch.float32) * scale
            mm.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            vv.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            du = (mm / bc1) / (torch.sqrt(vv / bc2) + cfg.eps) + cfg.weight_decay * p
            return (-lr * du).to(p.dtype)

        updates = _map(upd, params, state.m, state.v, grads)
        return updates, AdamWState(step, state.m, state.v)

    return Optimizer(init, update)


def apply_updates(params: Any, updates: Any) -> Any:
    """``params + updates``, written into ``params``; returns ``params``."""
    for (_, p), (_, u) in zip(pr.flatten(params), pr.flatten(updates)):
        p.add_(u)
    return params


def opt_shapes(params_shapes: Any) -> AdamWState:
    """TensorSpec tree of the state (mirrors ``init``)."""
    zeros = _map(lambda p: TensorSpec(tuple(p.shape), torch.float32), params_shapes)
    return AdamWState(TensorSpec((), torch.int32), zeros, _map(lambda z: z, zeros))
