"""Synthetic data (twin of the JAX package's ``data/synthetic.py``):
batches for every modality (text / audio / vlm), as ``TensorSpec`` trees
and materialized.

The audio/vlm frontends are the reference's stubs: ``frames`` stands in
for conv-extracted audio features, ``patches`` for SigLIP patch
embeddings. Token streams are Zipf-distributed with a deterministic shift
structure (every other token a function of the one before), so a language
model has something learnable. The draws come from a ``torch.Generator``
(the reference's come from ``jax.random``, so the two packages' batches
for one seed differ; the tests carry batches across as numpy arrays).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models.layers import cdtype
from repro_torch.models.model import TensorSpec


def _text_seq_len(cfg: ArchConfig, seq_len: int) -> int:
    """vlm: ``seq_len`` counts patches + text tokens."""
    if cfg.modality == "vlm":
        return seq_len - cfg.n_patches
    return seq_len


def batch_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """The batch's leaves as TensorSpecs (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, cdtype(cfg)
    if shape.kind == "decode":
        return {"tokens": TensorSpec((b, 1), i32)}
    st = _text_seq_len(cfg, s)
    out: dict = {}
    if cfg.modality == "audio":
        out["frames"] = TensorSpec((b, s, cfg.frontend_dim), dt)
    elif cfg.modality == "vlm":
        out["patches"] = TensorSpec((b, cfg.n_patches, cfg.d_model), dt)
        out["tokens"] = TensorSpec((b, st), i32)
    else:
        out["tokens"] = TensorSpec((b, s), i32)
    if shape.kind == "train":
        out["targets"] = TensorSpec((b, st if cfg.modality != "audio" else s), i32)
        if cfg.modality == "audio":
            out["mask"] = TensorSpec((b, s), torch.float32)
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
    ``device`` (the generator's by default). A text train batch draws (b,
    s + 1) tokens and splits them into tokens and next-token targets; a vlm
    batch's s counts its patches; an audio train batch draws frames, then
    targets, then a mask of about 8% of the frames (HuBERT-style masked
    prediction)."""
    b, s = shape.global_batch, shape.seq_len
    dt = cdtype(cfg)
    gdev = generator.device
    out: dict = {}
    if shape.kind == "decode":
        out["tokens"] = _zipf_tokens(generator, (b, 1), cfg.vocab_size)
    elif cfg.modality == "audio":
        out["frames"] = torch.randn((b, s, cfg.frontend_dim), generator=generator,
                                    device=gdev).to(dt)
        if shape.kind == "train":
            out["targets"] = _zipf_tokens(generator, (b, s), cfg.vocab_size)
            out["mask"] = (torch.rand((b, s), generator=generator, device=gdev)
                           < 0.08).to(torch.float32)
    else:
        if cfg.modality == "vlm":
            out["patches"] = torch.randn((b, cfg.n_patches, cfg.d_model), generator=generator,
                                         device=gdev).to(dt)
        toks = _zipf_tokens(generator, (b, _text_seq_len(cfg, s) + 1), cfg.vocab_size)
        out["tokens"] = toks[:, :-1]
        if shape.kind == "train":
            out["targets"] = toks[:, 1:]
    dev = gdev if device is None else device
    return {k: v.contiguous().to(dev) for k, v in out.items()}
