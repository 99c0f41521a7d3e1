"""Batched serving demo in the PyTorch port: prefill + cached greedy decode
for a decode-capable arch, with per-request stop handling (the twin of
``examples/serve_batched.py``).

  PYTHONPATH=src python examples/serve_batched_torch.py --arch zamba2-7b
  PYTHONPATH=src python examples/serve_batched_torch.py --arch qwen3-0.6b --device cpu
  PYTHONPATH=src python examples/serve_batched_torch.py --continuous --device cpu

The arch runs at its reduced config (``get_config(arch).reduced()``), as
the reference's example runs it. The prompts are the reference's (numpy,
seed 0); the parameters are drawn from ``torch.Generator(...).
manual_seed(0)``, not the reference's ``jax.random`` numbers, so the
tokens agree with the JAX example's only where the weights are carried
across (``tests/test_torch_lm.py``). On the card every zamba2 prefill
runs K6 (the SSD chunk step; a prompt of at most one 32-token chunk, or a
multiple of 32, opens its gate, as it opens the reference's Pallas gate),
twice per Mamba2 block; K5 stays shut (its gate needs head dim 128 and a
sequence a multiple of 512).

``build_model``, ``static_prompts`` and ``continuous_requests`` make the
run's model and inputs; ``static`` and ``continuous`` return the generated
tokens as lists of ints; ``run`` returns the run's results as plain Python,
and ``main`` prints the reference's lines and a final ``json`` line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.models.model import Model
from repro_torch.serving.continuous import ContinuousEngine, Request
from repro_torch.serving.engine import ServeEngine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def static(model: Model, prompts: list[np.ndarray], *, batch: int, max_seq: int = 128,
           max_new: int = 12, eos_id: int = 1, device: str | torch.device = "cuda"
           ) -> list[list[int]]:
    """One static batch through ``ServeEngine``: each prompt's tokens."""
    engine = ServeEngine(model, max_batch=batch, max_seq=max_seq, eos_id=eos_id,
                         device=device)
    return [o.tolist() for o in engine.generate(prompts, max_new=max_new)]


def continuous(model: Model, requests: list[tuple[np.ndarray, int]], *, batch: int,
               max_seq: int = 128, eos_id: int = -1, device: str | torch.device = "cuda"
               ) -> list[list[int]]:
    """(prompt, max_new) requests through ``ContinuousEngine``'s slots:
    each request's tokens."""
    engine = ContinuousEngine(model, max_batch=batch, max_seq=max_seq, eos_id=eos_id,
                              device=device)
    return [r.out for r in engine.serve([Request(p, m) for p, m in requests])]


def build_model(arch: str, device: torch.device) -> Model:
    """``arch`` at its reduced config, its parameters drawn from seed 0."""
    cfg = get_config(arch).reduced()
    if cfg.is_encoder:
        raise SystemExit("encoder-only arch: pick a decoder")
    return build(cfg).init(torch.Generator(device=device).manual_seed(0), device=device)


def static_prompts(vocab_size: int, batch: int) -> list[np.ndarray]:
    """The static batch's ragged prompts (4-19 tokens), the reference's draws."""
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab_size, size=int(rng.integers(4, 20))).astype(np.int32)
            for _ in range(batch)]


def continuous_requests(vocab_size: int, batch: int, max_new: int
                        ) -> list[tuple[np.ndarray, int]]:
    """Twice ``batch`` (prompt of 3-11 tokens, max_new) requests, the
    reference's draws."""
    rng = np.random.default_rng(0)
    return [(rng.integers(2, vocab_size, size=int(rng.integers(3, 12))).astype(np.int32),
             int(rng.integers(4, max_new + 1)))
            for _ in range(batch * 2)]   # 2x oversubscribed


def run(arch: str = "zamba2-7b", batch: int = 4, max_new: int = 12, *,
        continuous_batching: bool = False, device: str | torch.device = "cuda",
        log=print) -> dict:
    """The reference example's run; returns the tokens, their count and
    the wall seconds."""
    dev = resolve_device(device)
    model = build_model(arch, dev)
    cfg = model.cfg
    if continuous_batching:
        reqs = continuous_requests(cfg.vocab_size, batch, max_new)
        t0 = time.perf_counter()
        outs = continuous(model, reqs, batch=batch, device=dev)
        _sync(dev)
        dt = time.perf_counter() - t0
        n = sum(len(o) for o in outs)
        for i, ((prompt, _), out) in enumerate(zip(reqs, outs)):
            log(f"[serve-cb] req{i} ({len(prompt)} prompt toks) -> {out}")
        log(f"[serve-cb] {len(reqs)} reqs on {batch} slots: {n} tokens in {dt:.1f}s")
        return {"arch": cfg.name, "continuous": True, "tokens": outs, "n_tokens": n,
                "seconds": dt}

    prompts = static_prompts(cfg.vocab_size, batch)
    log(f"[serve] {batch} ragged requests (lens {[len(p) for p in prompts]}) on {cfg.name}")
    t0 = time.perf_counter()
    outs = static(model, prompts, batch=batch, max_new=max_new, device=dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    for i, o in enumerate(outs):
        log(f"[serve] response {i}: {o}")
    n = sum(len(o) for o in outs)
    pos = model.cache_shapes(batch, 128)["pos"]
    log(f"[serve] {n} tokens in {dt:.2f}s ({n / dt:.1f} tok/s incl. first calls; "
        f"cache pos shape = {tuple(pos.shape)})")
    return {"arch": cfg.name, "continuous": False, "tokens": outs, "n_tokens": n,
            "seconds": dt}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-7b", choices=ARCH_NAMES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--continuous", action="store_true",
                    help="vLLM-style slot scheduler: more requests than "
                         "slots, refilled mid-flight (per-slot positions)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    res = run(args.arch, args.batch, args.max_new, continuous_batching=args.continuous,
              device=args.device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
