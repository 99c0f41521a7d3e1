"""Multi-pod dry run (twin of the JAX package's ``launch/dryrun.py``):
trace one step of every (arch x input shape) on the production meshes,
per device, without allocating it, and derive memory, cost and the
roofline terms at the H100's constants (``launch/mesh.py``).

The reference lowers and compiles each step for 256 or 512 placeholder
host devices and reads XLA's memory analysis and the compiled HLO. The
port has no compiler to ask, so it runs the step itself:

  * the world is fake (``launch.mesh.make_production_mesh``: one process
    is rank 0 of a 16x16 or 2x16x16 ``DeviceMesh``, and collectives move
    nothing), and every tensor is a fake tensor (``FakeTensorMode``): the
    step runs op by op with shapes and no data;
  * the parameters, optimizer state, batch and cache are DTensors placed
    by ``sharding.rules`` (fake local shards of the right shapes);
  * ``launch.cost_analysis.CostMode`` counts each op on its local shapes
    (flops, HBM bytes, collective bytes by type) and the live storages
    (the step's peak of temporaries).

Like the reference, which lowers on host devices where no Pallas kernel
is taken, the step traces the plain paths: the tensors are (fake) CPU
tensors, so K5's and K6's gates stay shut. On the card the same mesh
Model launches them on each rank's local shard.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k [--multi-pod] [--out results.jsonl] [--naive-attn]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import torch

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config, shape_applicable
from repro_torch.data.synthetic import batch_specs
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, INTER_NODE_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.models import build, for_shape
from repro_torch.models import params as pr
from repro_torch.optim import AdamWConfig, adamw, cosine_warmup
from repro_torch.sharding import rules
from repro_torch.training import TrainState, make_train_step


def _optimizer():
    return adamw(AdamWConfig(), cosine_warmup(3e-4, 100, 10_000))


def input_specs(arch: str, shape_name: str, mesh, *, kind=None, strategy: str = "2d",
                align_heads: bool = True, seq_shard: bool = False,
                context_parallel: bool = False, moe_wg: bool = False,
                cfg_overrides: dict | None = None):
    """(model, args): the mesh Model and every input of the step as
    DTensors placed by the sharding rules. Call it under ``FakeTensorMode``
    (as ``run_one`` does): the tensors are then fake and nothing is
    allocated. For prefill and decode the parameters are also the model's
    own (``load_params``)."""
    shape = INPUT_SHAPES[shape_name]
    cfg = for_shape(get_config(arch), shape_name)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    act_axes = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    model = build(cfg, act_axes=act_axes, mesh=mesh, seq_shard=seq_shard,
                  context_parallel=context_parallel, moe_wg=moe_wg)
    model.place_params(strategy, align_heads)
    kind = kind or shape.kind
    bspecs = batch_specs(cfg, shape)
    batch = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in bspecs.items()}
    batch = rules.distribute(batch, mesh, rules.batch_pspecs(cfg, mesh, batch, strategy))
    params = model.distribute_params(pr.shape_tree(model.param_specs(), device="cpu"))
    if kind == "train":
        return model, (TrainState(params, _optimizer().init(params)), batch)
    model.load_params(params, device="cpu")
    if kind == "prefill":
        return model, (params, batch)
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    return model, (params, cache, batch)


def auto_microbatches(cfg, shape, mesh) -> int:
    """Grad-accumulation depth targeting ~1-4 sequences per device per
    micro-step by model size (activation memory ~ d_model * n_layers)."""
    sizes = rules.mesh_shape(mesh)
    batch_shards = 1
    for a, n in sizes.items():
        if a in ("pod", "data"):
            batch_shards *= n
    per_dev = max(1, shape.global_batch // batch_shards)
    target = 1 if cfg.d_model >= 7168 else (2 if cfg.d_model >= 3584 else 4)
    if cfg.n_experts:
        # MoE activations are ~k/cf x larger (per-token expert buffers)
        target = max(1, target // 2)
    return max(1, per_dev // target)


def step_fn(model, shape_name: str, kind: str, *, chunked_attn=None,
            microbatches: int | None = 4):
    """The step as a function of ``input_specs``'s args."""
    shape = INPUT_SHAPES[shape_name]
    if kind == "train":
        return make_train_step(model, _optimizer(), microbatches=microbatches)
    if kind == "prefill":
        def prefill(params, batch):
            return model.prefill(batch, shape.seq_len, chunked_attn=chunked_attn)
        return prefill

    def decode(params, cache, batch):
        return model.decode_step(cache, batch)
    return decode


def model_flops(cfg, shape, kind: str) -> float:
    """Analytic MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), with
    N_active for MoE."""
    n = build(cfg).param_count()
    if cfg.n_experts:
        expert = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts * cfg.n_layers
        n = n - expert + expert * cfg.experts_per_token / cfg.n_experts
    tokens = shape.global_batch * (1 if kind == "decode" else shape.seq_len)
    return (6.0 if kind == "train" else 2.0) * n * tokens


def trace(fn, args) -> tuple[cost_analysis.StepCost, dict]:
    """Run ``fn(*args)`` under ``CostMode``: (its cost, its memory: the
    arguments', the temporaries' peak and the outputs' bytes on this
    rank)."""
    from torch.distributed.tensor import DTensor

    with cost_analysis.CostMode(exclude=args) as mode:
        out = fn(*args)
    new = [t for t in torch.utils._pytree.tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    mem = {"arg_bytes": cost_analysis.local_bytes(args),
           "temp_bytes": mode.peak,
           "output_bytes": cost_analysis.local_bytes(
               [t.to_local() if isinstance(t, DTensor) else t for t in new])}
    return mode.cost(), mem


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            chunked_attn=None, microbatches: int | None = 4,
            strategy: str = "2d", align_heads: bool = True,
            seq_shard: bool = False, context_parallel: bool = False,
            moe_wg: bool = False, cfg_overrides: dict | None = None,
            verbose: bool = True, mesh=None) -> dict:
    """One record: the step of ``arch`` x ``shape_name`` traced on the
    production mesh (or ``mesh``), with the reference's keys."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape = INPUT_SHAPES[shape_name]
    cfg = for_shape(get_config(arch), shape_name)
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "strategy": strategy, "microbatches": microbatches,
           "align_heads": align_heads, "seq_shard": seq_shard,
           "context_parallel": context_parallel, "moe_wg": moe_wg,
           "cfg_overrides": cfg_overrides}
    if not ok:
        rec["skipped"] = why
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape_name}: {why}")
        return rec

    t0 = time.time()
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    rec["mesh"] = "x".join(str(n) for n in mesh.shape)
    if not microbatches:  # 0/None -> auto
        microbatches = auto_microbatches(cfg, shape, mesh)
        rec["microbatches"] = microbatches
    with FakeTensorMode(), torch.no_grad() if shape.kind != "train" else contextlib.nullcontext():
        model, args = input_specs(arch, shape_name, mesh, strategy=strategy,
                                  align_heads=align_heads, seq_shard=seq_shard,
                                  context_parallel=context_parallel, moe_wg=moe_wg,
                                  cfg_overrides=cfg_overrides)
        fn = step_fn(model, shape_name, shape.kind, chunked_attn=chunked_attn,
                     microbatches=microbatches)
        cost, mem = trace(fn, args)
    t1 = time.time()

    terms = cost_analysis.roofline_terms(cost, peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW,
                                         ici_bw=INTER_NODE_BW)
    n_dev = mesh.size()
    mf = model_flops(cfg, shape, shape.kind)
    rec.update(
        trace_s=round(t1 - t0, 1),
        n_devices=n_dev,
        **mem,
        fits_hbm=bool(mem["arg_bytes"] + mem["temp_bytes"] <= HBM_BYTES),
        hlo_flops_per_dev=cost.flops,
        hbm_bytes_per_dev=cost.hbm_bytes,
        coll_bytes_per_dev=cost.coll_bytes,
        coll_by_type={k: int(v) for k, v in cost.coll_by_type.items()},
        model_flops=mf,
        useful_flops_ratio=(mf / (cost.flops * n_dev) if cost.flops else None),
        **terms,
    )
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} on {rec['mesh']} (trace {rec['trace_s']}s)")
        print(f"  memory per device: args={rec['arg_bytes']} temp={rec['temp_bytes']} "
              f"out={rec['output_bytes']} fits_hbm={rec['fits_hbm']} (80 GB)")
        print(f"  cost per device: flops={cost.flops:.4e} hbm_bytes={cost.hbm_bytes:.4e} "
              f"coll_bytes={cost.coll_bytes:.4e}")
        print(f"  roofline (H100 SXM): compute={terms['compute_s']:.4f}s "
              f"memory={terms['memory_s']:.4f}s collective={terms['collective_s']:.4f}s "
              f"-> {terms['bottleneck']}-bound")
        print(f"  collectives: {rec['coll_by_type']}")
        print(f"  MODEL_FLOPS={mf:.3e} useful-ratio="
              f"{rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)}")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES), nargs="+",
                    help="one or more input shapes (traced in turn on one fake world)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--naive-attn", action="store_true",
                    help="ablation: O(S^2)-score attention path")
    ap.add_argument("--strategy", default="2d", choices=rules.STRATEGIES)
    ap.add_argument("--no-align-heads", action="store_true",
                    help="ablation: allow misaligned flattened-head TP")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-parallel residual stream")
    ap.add_argument("--context-parallel", action="store_true",
                    help="shard attention q-chunks over 'model'")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="grad-accumulation micro-steps for train shapes "
                         "(0 = auto by model size)")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("pass --arch and --shape, or --all")

    chunked = False if args.naive_attn else None
    pairs = ([(a, s) for a in ARCH_NAMES for s in INPUT_SHAPES]
             if args.all else [(args.arch, s) for s in args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records = []
    # One fake world per mesh size: the meshes' sweeps run one after the other.
    for mp in meshes:
        for arch, shape_name in pairs:
            try:
                rec = run_one(arch, shape_name, multi_pod=mp, chunked_attn=chunked,
                              microbatches=args.microbatches, strategy=args.strategy,
                              align_heads=not args.no_align_heads,
                              seq_shard=args.seq_shard,
                              context_parallel=args.context_parallel)
            except Exception as e:  # record and keep sweeping
                rec = {"arch": arch, "shape": shape_name,
                       "mesh": "2x16x16" if mp else "16x16",
                       "error": f"{type(e).__name__}: {e}"}
                print(f"[dryrun] FAIL {arch} x {shape_name} ({rec['mesh']}): "
                      f"{rec['error'][:200]}")
            records.append(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        if len(meshes) > 1:
            torch.distributed.destroy_process_group()
    n_ok = sum(1 for r in records if "skipped" not in r and r.get("fits_hbm"))
    print(f"[dryrun] done: {len(records)} records, {n_ok} traced+fit")


if __name__ == "__main__":
    main()
