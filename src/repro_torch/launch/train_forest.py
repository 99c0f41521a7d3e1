"""Train -> serve -> retrain -> hot-swap: the paper's full loop in one
command, on the port (the twin of ``repro.launch.train_forest``).

Trains a rotation forest MapReduce-style on synthetic EEG (each map
shard denoises, featurizes and fits a sub-forest; global feature
moments; union reduce), freezes it into a
``ScoringProgram`` through the checkpoint store, loads it back, streams a
held-out chronological timeline through a ``SeizureEngine`` in
chunk-unaligned pieces and checks the served alarms against
``pipeline.evaluate_timeline``. Then it retrains on fresh shards, swaps
the new program into the running engine mid-stream, and checks the
version stamps and the composite old/new alarm oracle. Exits 1 on any
mismatch.

  PYTHONPATH=src python -m repro_torch.launch.train_forest --device cpu \\
      --trees 4 --depth 4 --bins 8 --train-chunks 4 --hours-interictal 0

``--shards S`` runs the S map shards one after the other on ``--device``;
``--devices N --backend {nccl,gloo}`` runs the real mesh job instead: N
ranks over ``torch.distributed`` (``launch.mesh.spawn_world``), each
running this whole program on its own device with the same seeds (both
fits, serving and the checks), rank 0 writing the checkpoints and
printing. ``nccl`` needs a card per rank; ``gloo`` also serves ranks that
share a card, or CPU ranks with ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train_forest --device cpu \\
      --devices 2 --backend gloo --trees 4 --depth 4 --bins 8 \\
      --train-chunks 4 --hours-interictal 0

The exit code is 1 if any rank fails or any check fails. The reference
also counts recompiles across the swap; the port runs eagerly and has no
compile budget yet (ROADMAP.md queue 1, "Static checks for the port").
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.rotation_forest import RotationForestConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serving import ChunkScored, ScoringProgram, SeizureEngine
from repro_torch.signal import eeg_data, pipeline


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--patient", type=int, default=3)
    ap.add_argument("--shards", type=int, default=2,
                    help="map shards, emulated one after the other (unless --devices)")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks of a real torch.distributed mesh job, one map shard "
                         "each (0 = emulate --shards in one process)")
    ap.add_argument("--backend", choices=mesh_lib.BACKENDS, default=None,
                    help="the mesh job's backend; required with --devices")
    ap.add_argument("--trees", type=int, default=8)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--bins", type=int, default=16)
    ap.add_argument("--train-chunks", type=int, default=4,
                    help="8-minute training chunks (half interictal, half "
                         "preictal); must shard evenly")
    ap.add_argument("--hours-interictal", type=int, default=1,
                    help="held-out interictal hours before the run-up")
    ap.add_argument("--batch", type=int, default=4, help="engine slots")
    ap.add_argument("--replay-depth", type=int, default=4,
                    help="backlogged chunks one engine step scores per slot")
    ap.add_argument("--latency-budget", type=float, default=None,
                    help="seconds before poll(drain=False) flushes a partial "
                         "batch (default: drain fully each poll)")
    ap.add_argument("--overlap", type=int, default=0,
                    help="raw windows of the previous chunk added to each "
                         "MSPCA matrix (0 = independent chunks)")
    ap.add_argument("--save-dir", default=None,
                    help="ScoringProgram checkpoint dir (default: a temp dir)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; with --devices, the ranks' device type")
    return ap


def main(argv: list[str] | None = None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.devices <= 0:
        return run(args)
    if args.backend is None:
        ap.error("--devices needs --backend nccl or --backend gloo")
    # One checkpoint directory for the world: rank 0 writes, every rank reads.
    args.save_dir = args.save_dir or tempfile.mkdtemp(prefix="seizure_ckpt_")
    world = mesh_lib.spawn_world(
        _rank_main, args.devices, backend=args.backend, device=args.device, args=(args,)
    )
    for rank, tb in sorted(world.errors.items()):
        print(f"[rank {rank}] FAILED\n{tb}", file=sys.stderr)
    return 1 if world.returncode or any(world.results) else 0


def _rank_main(rank: int, device: torch.device, args: argparse.Namespace) -> int:
    """One rank of the mesh job: the whole program on its device; only
    rank 0 prints."""
    mesh = mesh_lib.make_host_mesh(data=args.devices, device_type=device.type)
    quiet = contextlib.redirect_stdout(io.StringIO()) if rank else contextlib.nullcontext()
    with quiet:
        return run(args, mesh=mesh, device=device)


def run(args: argparse.Namespace, mesh=None, device: torch.device | None = None) -> int:
    """The loop on one device, over ``--shards`` emulated shards or, with
    ``mesh``, as one rank of the mesh job. Returns the exit code."""
    device = torch.device(args.device) if device is None else device
    leader = mesh is None or dist.get_rank() == 0
    save_dir = args.save_dir or tempfile.mkdtemp(prefix="seizure_ckpt_")

    def agree(ok: bool) -> bool:
        """Every rank's verdict (each rank leaves together, so none waits
        in a later collective for one that left)."""
        if mesh is None:
            return ok
        votes = [None] * dist.get_world_size()
        dist.all_gather_object(votes, ok)
        return all(votes)

    def checkpoint(fitted, step: int) -> None:
        if leader:
            ScoringProgram.from_fitted(fitted, cfg).save(save_dir, step=step)
        if mesh is not None:
            dist.barrier()

    per = eeg_data.WINDOWS_PER_MATRIX
    cfg = pipeline.PipelineConfig(
        forest=RotationForestConfig(
            n_trees=args.trees, n_subsets=3, depth=args.depth, n_classes=2, n_bins=args.bins,
        ),
        overlap=args.overlap,
    )
    if mesh is not None:
        shards, mode, fit_kwargs = args.devices, f"{args.backend} mesh", {"mesh": mesh}
    else:
        shards, mode, fit_kwargs = args.shards, "emulated", {"n_shards": args.shards}

    def generator(offset: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(args.seed + offset)

    def train(offset: int):
        half = args.train_chunks * per // 2
        rec = eeg_data.stratify_chunks(eeg_data.make_training_set(
            generator(offset), args.patient,
            n_interictal_windows=half, n_preictal_windows=half,
        ))
        t0 = time.perf_counter()
        fitted = pipeline.fit(generator(offset + 1), rec, cfg, **fit_kwargs)
        _sync(device)
        return rec, fitted, time.perf_counter() - t0

    # ---- map/reduce training --------------------------------------------
    rec, fitted, seconds = train(0)
    print(f"[train] {rec.windows.shape[0]} windows over {shards} map shards ({mode}) "
          f"-> union forest of {fitted.forest.rotation.shape[0]} trees in "
          f"{seconds:.1f}s on {device}")

    # ---- freeze + round-trip through the checkpoint store ---------------
    checkpoint(fitted, 0)
    program = ScoringProgram.load(save_dir, device=device)
    print(f"[ckpt]  ScoringProgram saved + reloaded from {save_dir}")

    # ---- serve a held-out stream through the engine ---------------------
    timeline = eeg_data.make_test_timeline(
        generator(2), args.patient, hours_interictal=args.hours_interictal
    )
    wins = timeline.windows.cpu().numpy()
    engine = SeizureEngine(
        program, max_batch=args.batch, replay_depth=args.replay_depth,
        latency_budget_s=args.latency_budget, device=device,
    )
    session = engine.open_session(args.patient)
    events, t0 = [], time.perf_counter()
    drain_each = args.latency_budget is None
    for i in range(0, wins.shape[0], 37):  # deliberately chunk-unaligned
        session.push(wins[i : i + 37])
        events += engine.poll(drain=drain_each)
    events += engine.poll()
    dt = time.perf_counter() - t0
    scored = [e for e in events if isinstance(e, ChunkScored)]
    for e in scored:
        flag = " *** ALARM ***" if e.alarm else ""
        print(f"[serve] chunk {e.chunk_index:3d}: pred={e.chunk_pred} "
              f"frac={e.preictal_frac:.2f}{flag}")
    print(f"[serve] {wins.shape[0]} windows in {dt:.1f}s ({wins.shape[0] / dt:.1f} "
          f"windows/s, {engine.steps} engine steps at replay depth "
          f"{args.replay_depth}), final alarm={engine.alarm_state(args.patient)}")

    # ---- the loaded program must reproduce the offline oracle -----------
    res = pipeline.evaluate_timeline(fitted, timeline, cfg)
    got_alarms = [e.alarm for e in scored]
    if not agree(got_alarms == res.alarms.tolist()):
        print("[check] FAIL: served alarms diverge from pipeline oracle (on some rank)")
        return 1
    print(f"[check] served alarms == pipeline oracle ({sum(got_alarms)} alarm "
          f"chunks); lead time {float(res.lead_time_minutes):.0f} min (onset "
          f"chunk {int(res.onset_chunk)})")

    # ---- retrain on fresh shards -> hot-swap into the LIVE engine -------
    _, fitted2, seconds = train(3)
    checkpoint(fitted2, 1)
    program2 = ScoringProgram.load(save_dir, device=device)  # latest = the retrain
    print(f"[retrain] fresh shards -> new forest in {seconds:.1f}s, checkpointed as step 1")

    n_chunks = wins.shape[0] // per
    k_swap = max(1, n_chunks // 2)
    session2 = engine.open_session(args.patient + 1000)
    session2.push(wins[: k_swap * per])
    events2 = engine.poll()  # k_swap chunks under the old program
    t0 = time.perf_counter()
    version = engine.swap_program(program2)
    for i in range(k_swap * per, n_chunks * per, 37):
        session2.push(wins[i : min(i + 37, n_chunks * per)])
        events2 += engine.poll()
    events2 += engine.poll()
    swap_ms = (time.perf_counter() - t0) * 1e3
    scored2 = [e for e in events2 if isinstance(e, ChunkScored)]
    versions = [e.program_version for e in scored2]
    if not agree(versions == [0] * k_swap + [version] * (n_chunks - k_swap)):
        print(f"[swap] FAIL: program_version stamps wrong (on some rank): {versions}")
        return 1

    # Composite oracle: chunk votes depend only on the serving program, so
    # the expected alarms are the k-of-m rule over the old program's votes
    # up to the swap and the new program's after it.
    res2 = pipeline.evaluate_timeline(fitted2, timeline, cfg)
    combined = torch.cat([res.chunk_preds[:k_swap], res2.chunk_preds[k_swap:n_chunks]])
    want2 = pipeline.alarm_state(combined, cfg).tolist()
    if not agree([e.alarm for e in scored2] == want2):
        print("[swap] FAIL: post-swap served alarms diverge from the composite "
              "old/new pipeline oracle (on some rank)")
        return 1
    changed = int(np.sum(
        res.chunk_preds[:n_chunks].numpy() != res2.chunk_preds[:n_chunks].numpy()
    ))
    print(f"[swap] v{version} live after chunk {k_swap}/{n_chunks}: swap+serve tail "
          f"in {swap_ms:.0f} ms, served alarms == composite oracle ({changed} chunk "
          "votes differ between programs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
