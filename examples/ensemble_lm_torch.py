"""The paper's MapReduce ensemble schedule generalized to the model zoo, in
the PyTorch port (the twin of ``examples/ensemble_lm.py``): train N bagged
members of an architecture on disjoint data shards with NO gradient sync,
then vote-reduce their predictions.

  PYTHONPATH=src python examples/ensemble_lm_torch.py --members 4 --steps 15 --device cpu

Every family trains (``--arch xlstm-1.3b``, the reference's example, too);
the default arch is qwen3-0.6b, reduced, as the reference's.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.data.synthetic import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.training.trainer import ensemble_init, make_ensemble_train_step, member


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_NAMES)
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = build(cfg)
    opt = adamw(AdamWConfig(lr=1e-3))
    print(f"[ensemble] {args.members} x {cfg.name} "
          f"({model.param_count():,} params each)")

    states = ensemble_init(model, opt, torch.Generator(device=device).manual_seed(0),
                           args.members, device)
    step = make_ensemble_train_step(model, opt, None, args.members)
    shape = InputShape("ens", 64, 4 * args.members, "train")

    for i in range(args.steps):
        batch = make_batch(cfg, shape, torch.Generator().manual_seed(i), device)
        states, metrics = step(states, batch)
        losses = " ".join(f"{x:.3f}" for x in metrics["loss"].tolist())
        if i % 5 == 0 or i == args.steps - 1:
            print(f"[ensemble] step {i}: member losses [{losses}]")

    # --- vote-reduce (the paper's reduce phase) ---------------------------
    eval_batch = make_batch(cfg, InputShape("eval", 64, 2, "train"),
                            torch.Generator().manual_seed(99), device)
    targets = eval_batch["targets"].long()[..., None]
    with torch.no_grad():
        member_logits = torch.stack([model.apply(member(states.params, m), eval_batch)[0]
                                     for m in range(args.members)])
    vote_probs = torch.softmax(member_logits, -1).mean(0)
    vote_nll = -torch.log(torch.gather(vote_probs, -1, targets) + 1e-9).mean()
    single_probs = torch.softmax(member_logits[0], -1)
    single_nll = -torch.log(torch.gather(single_probs, -1, targets) + 1e-9).mean()
    print(f"[ensemble] held-out NLL: single member {float(single_nll):.4f} "
          f"vs {args.members}-member vote {float(vote_nll):.4f} "
          "(ensemble <= single, the paper's claim)")


if __name__ == "__main__":
    main()
