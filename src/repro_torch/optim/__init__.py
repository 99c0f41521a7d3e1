"""Optimizers (twin of the JAX package's ``optim``)."""

from repro_torch.optim.adamw import AdamWConfig, adamw, apply_updates
from repro_torch.optim.schedule import constant, cosine_warmup, linear_warmup

__all__ = ["AdamWConfig", "adamw", "apply_updates",
           "cosine_warmup", "linear_warmup", "constant"]
