"""LM serving entry point: batched prefill + cached greedy decode (the twin of
``repro.launch.serve``), on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --reduced --device cpu

Every text arch serves (dense, moe, hybrid, xlstm). An encoder (hubert)
exits, as the reference's launcher does; a vlm arch (paligemma) raises in
the engine, which feeds tokens only, as the reference's does
(``serving.engine.check_servable``).

Parameters are drawn from ``torch.Generator(...).manual_seed(--seed)``
(not the reference's ``jax.random`` numbers) and the prompts from numpy
with the same seed, as the reference draws them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.serving.engine import ServeEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    model = build(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model.init(gen, device=device)
    engine = ServeEngine(model, max_batch=args.batch, max_seq=args.max_seq,
                         device=device)

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(2, cfg.vocab_size, size=rng.integers(4, 17))
               .astype(np.int32) for _ in range(args.batch)]
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new=args.max_new)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    for i, (p, o) in enumerate(zip(prompts, outs)):
        print(f"[serve] req{i}: prompt={p.tolist()[:8]}... -> "
              f"gen={o.tolist()}")
    n_tok = sum(len(o) for o in outs)
    print(f"[serve] {n_tok} tokens in {dt:.2f}s on {device} "
          f"({n_tok / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
