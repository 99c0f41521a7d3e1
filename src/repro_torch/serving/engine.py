"""LM serving: batched prefill + cached greedy decode (twin of the JAX
package's ``serving/engine.py``).

``make_serve_step`` is ONE new token against a KV cache of ``max_seq``.
``ServeEngine`` is the host-side loop: it left-pads the requests into a
fixed batch, runs prefill once, then steps the decoder, with per-request
stop handling. The cache is updated in place (the reference donates it).

The engines serve the text modality of every family (dense, moe, hybrid,
ssm). Like the reference's, they feed the model ``{"tokens"}`` only, so a
vlm model (whose prefill needs ``patches``) or an audio encoder (no decode
step) cannot be served through them; here they say so when built
(``check_servable``), where the reference's fail at the first prefill.
Such a model runs through ``Model.prefill`` / ``decode_step`` directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import Model


def make_serve_step(model: Model):
    """(cache, tokens (B,1)) -> (logits (B,1,V), new cache)."""

    def serve_step(cache, batch):
        return model.decode_step(cache, batch)

    return serve_step


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, S, V) -> (B, 1) int32 argmax of the last position (ties to the
    first index, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)


def check_model_device(model: Model, device: torch.device) -> None:
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if model.device != device:
        raise ValueError(f"the model's parameters are on {model.device}, the engine "
                         f"runs on {device}")


def check_servable(model: Model) -> None:
    """Raise for a model the token-only engines cannot serve: an encoder
    (no decode step) or a non-text modality (its prefill needs frames or
    patches)."""
    cfg = model.cfg
    if cfg.is_encoder or cfg.modality != "text":
        raise ValueError(
            f"{cfg.name}: the engines feed tokens only, as the reference's do; a "
            f"{cfg.modality} {'encoder' if cfg.is_encoder else 'model'} is served through "
            "Model.prefill / decode_step" + (" (an encoder has no decode step)"
                                             if cfg.is_encoder else ""))


@dataclasses.dataclass
class ServeEngine:
    """Static batches on ``device`` (the card by default; the model's
    parameters must already be there)."""

    model: Model
    max_batch: int
    max_seq: int
    eos_id: int = 1
    sample: Callable[[torch.Tensor], torch.Tensor] = staticmethod(greedy)
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        check_model_device(self.model, self.device)
        check_servable(self.model)
        self._step = make_serve_step(self.model)

    def _pad_requests(self, prompts: list[np.ndarray]) -> torch.Tensor:
        assert len(prompts) <= self.max_batch
        width = max(len(p) for p in prompts)
        batch = np.zeros((self.max_batch, width), np.int32)
        for i, p in enumerate(prompts):
            batch[i, width - len(p):] = p   # left-pad (simple static batcher)
        return torch.from_numpy(batch).to(self.device)

    def generate(self, prompts: list[np.ndarray], max_new: int = 32
                 ) -> list[np.ndarray]:
        tokens = self._pad_requests(prompts)
        logits, cache = self.model.prefill({"tokens": tokens}, self.max_seq)
        out = []
        done = np.zeros(self.max_batch, bool)
        cur = self.sample(logits)
        for _ in range(max_new):
            out.append(cur[:, 0].cpu().numpy())
            done |= out[-1] == self.eos_id
            if done[: len(prompts)].all():
                break
            logits, cache = self._step(cache, {"tokens": cur})
            cur = self.sample(logits)
        gen = np.stack(out, axis=1)  # (B, T)
        return [gen[i] for i in range(len(prompts))]
