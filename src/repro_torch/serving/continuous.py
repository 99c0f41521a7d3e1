"""Continuous batching, a slot scheduler with static shapes (twin of the
JAX package's ``serving/continuous.py``).

The decode step always runs the full ``max_batch`` of slots; each slot
carries its OWN absolute position (per-slot ``pos`` in the cache, see
``models.layers.attn_decode``). When a request finishes, its slot is
refilled from the queue: the new prompt is prefilled at batch=1 and its
cache leaves are spliced into the live batch cache at the slot index
(``_splice``, which locates the batch axis of every leaf by shape
difference: axis 1 of the stacked K/V ``(L or sites, B, S, K, hd)``,
axis 2 of a hybrid model's ``mamba`` leaves ``(n_full, per, B, ...)``,
axis 1 of its ``mamba_rest``, axis 0 of ``pos``). A hybrid model's
prompts have at least ``ssm_conv - 1`` tokens (see ``models.ssm``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving.engine import check_model_device, greedy


def _splice(batch_cache: Any, one_cache: Any, slot: int) -> Any:
    """Write a batch=1 cache into slot ``slot`` of a batch=B cache, IN
    PLACE (the reference returns an updated copy of a donated cache, so no
    caller sees the difference); returns ``batch_cache``. A leaf whose
    shape equals the batch=1 leaf's is left as it is, as in the
    reference."""
    if isinstance(batch_cache, dict):
        for key in batch_cache:
            _splice(batch_cache[key], one_cache[key], slot)
        return batch_cache
    big, one = batch_cache, one_cache
    if big.shape == one.shape:          # scalars/shared leaves
        return big
    axis = next(i for i, (a, b) in enumerate(zip(big.shape, one.shape)) if a != b)
    big.narrow(axis, slot, 1).copy_(one)
    return big


@dataclasses.dataclass
class Request:
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ContinuousEngine:
    """Slots on ``device`` (the card by default; the model's parameters
    must already be there)."""

    model: Model
    max_batch: int
    max_seq: int
    eos_id: int = 1
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        check_model_device(self.model, self.device)

    def serve(self, requests: list[Request], max_steps: int = 10_000
              ) -> list[Request]:
        """Run until every request completes. Requests beyond
        ``max_batch`` wait in the queue and join as slots free up."""
        b = self.max_batch
        queue = list(requests)
        slots: list[Request | None] = [None] * b
        cache = self.model.init_cache(b, self.max_seq)
        cur = torch.zeros((b, 1), dtype=torch.int32, device=self.device)

        def admit(slot_id: int, cache, cur):
            req = queue.pop(0)
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int32)[None, :],
                                     device=self.device)
            logits1, cache1 = self.model.prefill({"tokens": prompt}, self.max_seq)
            cache = _splice(cache, cache1, slot_id)
            tok = int(torch.argmax(logits1[0, -1]))
            req.out.append(tok)
            slots[slot_id] = req
            cur[slot_id, 0] = tok
            return cache, cur

        for i in range(b):
            if queue:
                cache, cur = admit(i, cache, cur)

        for _ in range(max_steps):
            active = [i for i, r in enumerate(slots) if r is not None]
            if not active:
                break
            logits, cache = self.model.decode_step(cache, {"tokens": cur})
            nxt = greedy(logits)
            toks = nxt[:, 0].tolist()
            for i in active:
                req = slots[i]
                tok = toks[i]
                finished = (tok == self.eos_id
                            or len(req.out) >= req.max_new)
                if not finished:
                    req.out.append(tok)
                else:
                    req.done = True
                    slots[i] = None
                    if queue:   # refill the slot without stalling others
                        cache, nxt = admit(i, cache, nxt)
            cur = nxt
        return requests
