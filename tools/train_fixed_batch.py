#!/usr/bin/env python3
"""AdamW on one fixed batch at several step sizes, from the state that
``chip_smoke.py`` phase 7b reaches (qwen3-0.6b at full width, 4 steps of
8 x 2048 in 4 microbatches, then one step of 2 rows), on the card.

For each (lr, moments) it takes six steps on the same 2 x 2048 batch from
a copy of that state, with the trained moments carried or fresh, and
prints each step's loss in the bf16 step and the same parameters' loss in
float32 compute: where the two rise together, the step size overshoots
(the optimizer's doing, not bf16 rounding).

    python3 tools/train_fixed_batch.py
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

CASES = ((3e-5, False), (1e-5, False), (3e-6, False), (1e-5, True), (3e-6, True))


def main() -> int:
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import BatchStream
    from repro_torch.models import build
    from repro_torch.optim import AdamWConfig, adamw, cosine_warmup
    from repro_torch.training.trainer import TrainState, clone_tree, make_train_step

    if not torch.cuda.is_available():
        print("train_fixed_batch.py needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cfg, _ = cs.train_cfgs()
    model = build(cfg).init(torch.Generator(device="cuda").manual_seed(cs.SEED + 7),
                            device="cuda")
    params = model.master_params()
    opt = adamw(AdamWConfig(lr=cs.TR_LR), cosine_warmup(cs.TR_LR, 1, cs.TR_STEPS))
    state = TrainState(params, opt.init(params))
    stream = BatchStream(cfg, InputShape("train", cs.TR_SEQ, cs.TR_BATCH, "train"),
                         seed=cs.SEED, device="cuda")
    step = make_train_step(model, opt, microbatches=cs.TR_MICRO)
    for _, batch in zip(range(cs.TR_STEPS), stream):
        state, _ = step(state, batch)
    small = {k: v[:cs.TR_SMALL_BATCH] for k, v in stream.batch_at(cs.TR_STEPS).items()}
    state, _ = make_train_step(model, opt)(state, small)
    f32 = build(dataclasses.replace(cfg, dtype="float32"))
    for lr, fresh in CASES:
        b = clone_tree(state)
        o = adamw(AdamWConfig(lr=lr))
        if fresh:
            b = TrainState(b.params, o.init(b.params))
        fixed = make_train_step(model, o)
        l16, l32 = [], []
        for _ in range(6):
            with torch.no_grad():
                l32.append(float(f32.loss(b.params, small)[0]))
            b, m = fixed(b, small)
            l16.append(float(m["loss"]))
        print(f"lr {lr} {'fresh' if fresh else 'trained'} moments: bf16 losses "
              f"{[round(x, 4) for x in l16]}; float32 {[round(x, 4) for x in l32]}", flush=True)
        del b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
