"""Learning-rate schedules (twin of the JAX package's ``optim/schedule.py``):
pure functions of the step, a 0-dim integer tensor, returning a float32
0-dim tensor on the step's device, so a train step reads no host value."""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def linear_warmup(lr: float, warmup: int, total: int, floor: float = 0.0):
    def f(step):
        s = step.to(torch.float32)
        up = s / max(warmup, 1)
        down = 1.0 - (s - warmup) / max(total - warmup, 1)
        return lr * torch.clip(torch.minimum(up, down), floor / lr, 1.0)
    return f


def cosine_warmup(lr: float, warmup: int, total: int, floor_frac: float = 0.1):
    def f(step):
        s = step.to(torch.float32)
        up = s / max(warmup, 1)
        t = torch.clip((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return lr * torch.where(s < warmup, up, cos)
    return f
