"""LM training driver (the twin of ``repro.launch.train``), on the card by
default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --reduced \\
      --steps 20 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --reduced \\
      --steps 10 --ensemble 4 --device cpu    # the paper's MapReduce ensemble schedule

Every family trains (the audio and vlm batches carry their stub frames
and patches, see ``data.synthetic``). Parameters are drawn from
``torch.Generator(...).manual_seed(--seed)`` and batch i from a generator
seeded ``--seed + i + 1`` (the reference's ``make_batch`` seeds), not the
reference's ``jax.random`` numbers. Prints the reference's ``[train]``
lines, then the tokens/s of the steps after the first.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.data.synthetic import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.optim import AdamWConfig, adamw, cosine_warmup
from repro_torch.training import TrainState, make_train_step
from repro_torch.training.trainer import ensemble_init, make_ensemble_train_step, save_state


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--ensemble", type=int, default=0,
                    help="train N bagged members (paper schedule T1)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg)
    print(f"[train] {cfg.name}: {model.param_count():,} params, "
          f"{cfg.n_layers}L d={cfg.d_model}")

    opt = adamw(AdamWConfig(lr=args.lr),
                cosine_warmup(args.lr, max(args.steps // 10, 1), args.steps))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    shape = InputShape("cli", args.seq, args.batch, "train")

    if args.ensemble:
        state = ensemble_init(model, opt, gen, args.ensemble, device)
        step = make_ensemble_train_step(model, opt, None, args.ensemble)
    else:
        params = model.init(gen, device=device).master_params()
        state = TrainState(params, opt.init(params))
        step = make_train_step(model, opt, microbatches=args.microbatches or None)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    t_first = None
    for i in range(args.steps):
        batch = make_batch(cfg, shape, torch.Generator().manual_seed(args.seed + i + 1), device)
        state, metrics = step(state, batch)
        loss = metrics["loss"].detach().cpu()
        if t_first is None:
            sync()
            t_first = time.perf_counter()
        loss_s = (f"{float(loss):.4f}" if loss.ndim == 0
                  else "[" + " ".join(f"{x:.3f}" for x in loss.tolist()) + "]")
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"[train] step {i:4d} loss={loss_s} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
        if args.ckpt_dir and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            path = save_state(args.ckpt_dir, i + 1, state)
            print(f"[train] checkpoint -> {path}")
    sync()
    if not bool(torch.isfinite(metrics["loss"]).all()):
        raise SystemExit("[train] NaN loss")
    if args.steps > 1:
        tokens = (args.steps - 1) * args.batch * args.seq
        print(f"[train] {tokens / (time.perf_counter() - t_first):.1f} tokens/s over steps "
              f"1-{args.steps - 1} on {device}")
    print("[train] done")


if __name__ == "__main__":
    main()
