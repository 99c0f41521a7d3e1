"""Synthetic data (twin of the JAX package's ``data/synthetic.py``):
batches as ``TensorSpec`` trees and materialized, for the text modality.

Token streams are Zipf-distributed with a deterministic shift structure
(every other token a function of the one before), so a language model
has something learnable. The draws come from a ``torch.Generator`` (the
reference's come from ``jax.random``, so the two packages' batches for
one seed differ; the tests carry batches across as numpy arrays).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models.model import TensorSpec

_WAITING = 'ROADMAP.md queue 1, "The remaining LM families"'


def _text_only(cfg: ArchConfig) -> None:
    if cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.modality} batches wait for the {cfg.modality} frontend "
            f"({_WAITING})"
        )


def batch_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """The batch's leaves as TensorSpecs (no allocation)."""
    _text_only(cfg)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": TensorSpec((b, 1), torch.int32)}
    out = {"tokens": TensorSpec((b, s), torch.int32)}
    if shape.kind == "train":
        out["targets"] = TensorSpec((b, s), torch.int32)
    return out


def _zipf_tokens(generator: torch.Generator, shape: tuple, vocab: int) -> torch.Tensor:
    """Zipf-ish marginals + a shift structure so the next token is learnable."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device) * (1.0 - 1e-6) + 1e-6
    ranks = torch.floor(torch.exp(u * math.log(vocab))).to(torch.int32) - 1
    base = torch.clip(ranks, 0, vocab - 1)
    # deterministic structure: every other token is f(prev)
    rolled = (base * 31 + 7) % vocab
    odd = (torch.arange(shape[-1], device=base.device) % 2).bool()
    return torch.where(odd, torch.roll(rolled, 1, dims=-1), base)


def make_batch(cfg: ArchConfig, shape: InputShape, generator: torch.Generator,
               device: torch.device | str | None = None) -> dict:
    """One batch drawn from ``generator`` (on its own device), then moved to
    ``device`` (the generator's by default). A train batch draws (b, s + 1)
    tokens and splits them into tokens and next-token targets."""
    _text_only(cfg)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        out = {"tokens": _zipf_tokens(generator, (b, 1), cfg.vocab_size)}
    else:
        toks = _zipf_tokens(generator, (b, s + 1), cfg.vocab_size)
        out = {"tokens": toks[:, :-1]}
        if shape.kind == "train":
            out["targets"] = toks[:, 1:]
    dev = generator.device if device is None else device
    return {k: v.contiguous().to(dev) for k, v in out.items()}
