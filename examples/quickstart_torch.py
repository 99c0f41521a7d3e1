"""Quickstart in the PyTorch port: build an arch, train a few steps, decode
(the twin of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/quickstart_torch.py [--arch qwen3-0.6b]
  PYTHONPATH=src python examples/quickstart_torch.py --steps 3 --device cpu

The arch runs at its reduced config (``get_config(arch).reduced()``: CPU
sized, the published topology), as the reference's example runs it. The
parameters are drawn from ``torch.Generator(...).manual_seed(0)`` and
step i's batch from ``manual_seed(i)`` (the reference's ``make_batch``
seeds, not its ``jax.random`` numbers), so losses and tokens agree with
the JAX example's only in their statistics. The training steps need
gradients, which keep K5 and K6 shut (neither has a backward); the decode
of the default arch (qwen3-0.6b reduced, head dim 64) keeps K5 shut too
(its gate, the reference's, needs head dim 128 and a sequence a multiple
of 512), so at the defaults this path launches no kernel of the port. A
zamba2 arch's decode prefill runs K6, as ``serve_batched_torch.py``'s does.

``train`` and ``decode`` are the steps, ``run`` returns the results as
plain Python, and ``main`` prints the reference's lines and a final
``json`` line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.data.synthetic import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.serving.engine import ServeEngine
from repro_torch.training import TrainState, make_train_step

PROMPTS = (np.array([5, 6, 7], np.int32), np.array([9, 8], np.int32))


def train(model: Model, steps: int, *, device: str | torch.device = "cuda",
          log=print) -> tuple[TrainState, list[float]]:
    """AdamW (lr 1e-3) on synthetic token batches of 4 x 64, from the
    model's parameters; returns the state and each step's loss."""
    dev = resolve_device(device)
    opt = adamw(AdamWConfig(lr=1e-3))
    params = model.master_params()
    state = TrainState(params, opt.init(params))
    step = make_train_step(model, opt)
    shape = InputShape("quickstart", 64, 4, "train")
    losses = []
    for i in range(steps):
        state, metrics = step(state, make_batch(model.cfg, shape,
                                                torch.Generator().manual_seed(i), dev))
        losses.append(float(metrics["loss"]))
        log(f"step {i}: loss={losses[-1]:.4f}")
    return state, losses


def decode(model: Model, prompts=PROMPTS, *, batch: int = 2, max_seq: int = 96,
           max_new: int = 8, eos_id: int = 1, device: str | torch.device = "cuda"
           ) -> list[list[int]]:
    """Batched prefill + greedy decode with the KV/state cache
    (``ServeEngine``) on the model's parameters: each prompt's tokens."""
    engine = ServeEngine(model, max_batch=batch, max_seq=max_seq, eos_id=eos_id,
                         device=device)
    return [o.tolist() for o in engine.generate(list(prompts), max_new=max_new)]


def run(arch: str = "qwen3-0.6b", steps: int = 10, *, device: str | torch.device = "cuda",
        log=print) -> dict:
    dev = resolve_device(device)
    # 1. Config + model (reduced variant: CPU-sized, same topology).
    cfg = get_config(arch).reduced()
    model = build(cfg).init(torch.Generator(device=dev).manual_seed(0), device=dev)
    log(f"{cfg.name}: {model.param_count():,} params")
    # 2. A few train steps on synthetic token data.
    state, losses = train(model, steps, device=dev, log=log)
    # 3. Serve: batched prefill + greedy decode with a KV/state cache.
    outs = []
    if not cfg.is_encoder:
        model.load_params(state.params, device=dev)
        outs = decode(model, device=dev)
        for i, o in enumerate(outs):
            log(f"generated[{i}]: {o}")
    return {"arch": cfg.name, "params": model.param_count(), "losses": losses,
            "generated": outs}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.arch, args.steps, device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
