"""Deterministic batch stream (twin of the JAX package's
``data/pipeline.py``).

An infinite iterator of global batches; batch i is a pure function of
(seed, i), drawn on the CPU from a generator seeded ``seed * 1_000_003 +
i``, so it has the same bits on every device and in every process and any
step can be replayed after a checkpoint restore (``DataState`` goes into
the checkpoint beside the ``TrainState``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.data.synthetic import make_batch
from repro_torch.device import resolve_device
from repro_torch.sharding import rules


@dataclasses.dataclass
class DataState:
    seed: int
    step: int = 0


class BatchStream:
    """Deterministic synthetic stream: ``stream.batch_at(i)`` is stable
    across processes and restarts. Batches land on ``device`` (the card
    by default). With ``shardings = (mesh, specs)`` (a ``DeviceMesh`` and
    a tree of partition specs, e.g. ``sharding.rules.batch_pspecs``) each
    batch is placed as DTensors (``rules.distribute``): every rank draws the
    same global batch and keeps its own rows, with no communication (the
    reference's ``jax.device_put`` with shardings)."""

    def __init__(self, cfg: ArchConfig, shape: InputShape, seed: int = 0,
                 shardings: Any | None = None, device: torch.device | str | None = None):
        self.cfg = cfg
        self.shape = shape
        self.state = DataState(seed=seed)
        self.shardings = shardings
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> dict:
        gen = torch.Generator().manual_seed(self.state.seed * 1_000_003 + step)
        batch = make_batch(self.cfg, self.shape, gen, self.device)
        if self.shardings is not None:
            mesh, specs = self.shardings
            batch = rules.distribute(batch, mesh, specs)
        return batch

    def __iter__(self) -> Iterator[dict]:
        while True:
            b = self.batch_at(self.state.step)
            self.state.step += 1
            yield b

    # --- checkpoint integration -------------------------------------------
    def state_dict(self) -> dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: dict) -> None:
        self.state = DataState(**d)
