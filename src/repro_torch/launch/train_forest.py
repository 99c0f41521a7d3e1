"""Train -> serve -> retrain -> hot-swap: the paper's full loop in one
command, on the port (the twin of ``repro.launch.train_forest``).

Trains a rotation forest MapReduce-style on synthetic EEG (each of
``--shards`` emulated map shards denoises, featurizes and fits a
sub-forest; global feature moments; union reduce), freezes it into a
``ScoringProgram`` through the checkpoint store, loads it back, streams a
held-out chronological timeline through a ``SeizureEngine`` in
chunk-unaligned pieces and checks the served alarms against
``pipeline.evaluate_timeline``. Then it retrains on fresh shards, swaps
the new program into the running engine mid-stream, and checks the
version stamps and the composite old/new alarm oracle. Exits 1 on any
mismatch.

  PYTHONPATH=src python -m repro_torch.launch.train_forest --device cpu \\
      --trees 4 --depth 4 --bins 8 --train-chunks 4 --hours-interictal 0

The reference's ``--devices`` (a real mesh) is not ported: ``--shards``
runs the map shards one after the other on ``--device``. The reference
also counts recompiles across the swap; the port runs eagerly and has no
compile budget yet (ROADMAP.md, queue 1 item 13).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.rotation_forest import RotationForestConfig
from repro_torch.serving import ChunkScored, ScoringProgram, SeizureEngine
from repro_torch.signal import eeg_data, pipeline


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--patient", type=int, default=3)
    ap.add_argument("--shards", type=int, default=2, help="emulated map shards")
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
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    per = eeg_data.WINDOWS_PER_MATRIX
    cfg = pipeline.PipelineConfig(
        forest=RotationForestConfig(
            n_trees=args.trees, n_subsets=3, depth=args.depth, n_classes=2, n_bins=args.bins,
        ),
        overlap=args.overlap,
    )

    def generator(offset: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(args.seed + offset)

    def train(offset: int):
        half = args.train_chunks * per // 2
        rec = eeg_data.stratify_chunks(eeg_data.make_training_set(
            generator(offset), args.patient,
            n_interictal_windows=half, n_preictal_windows=half,
        ))
        t0 = time.perf_counter()
        fitted = pipeline.fit(generator(offset + 1), rec, cfg, n_shards=args.shards)
        _sync(device)
        return rec, fitted, time.perf_counter() - t0

    # ---- map/reduce training --------------------------------------------
    rec, fitted, seconds = train(0)
    print(f"[train] {rec.windows.shape[0]} windows over {args.shards} map shards "
          f"-> union forest of {fitted.forest.rotation.shape[0]} trees in "
          f"{seconds:.1f}s on {device}")

    # ---- freeze + round-trip through the checkpoint store ---------------
    save_dir = args.save_dir or tempfile.mkdtemp(prefix="seizure_ckpt_")
    path = ScoringProgram.from_fitted(fitted, cfg).save(save_dir)
    program = ScoringProgram.load(save_dir, device=device)
    print(f"[ckpt]  ScoringProgram saved + reloaded from {path}")

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
    if got_alarms != res.alarms.tolist():
        print("[check] FAIL: served alarms diverge from pipeline oracle")
        return 1
    print(f"[check] served alarms == pipeline oracle ({sum(got_alarms)} alarm "
          f"chunks); lead time {float(res.lead_time_minutes):.0f} min (onset "
          f"chunk {int(res.onset_chunk)})")

    # ---- retrain on fresh shards -> hot-swap into the LIVE engine -------
    _, fitted2, seconds = train(3)
    ScoringProgram.from_fitted(fitted2, cfg).save(save_dir, step=1)
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
    if versions != [0] * k_swap + [version] * (n_chunks - k_swap):
        print(f"[swap] FAIL: program_version stamps wrong: {versions}")
        return 1

    # Composite oracle: chunk votes depend only on the serving program, so
    # the expected alarms are the k-of-m rule over the old program's votes
    # up to the swap and the new program's after it.
    res2 = pipeline.evaluate_timeline(fitted2, timeline, cfg)
    combined = torch.cat([res.chunk_preds[:k_swap], res2.chunk_preds[k_swap:n_chunks]])
    want2 = pipeline.alarm_state(combined, cfg).tolist()
    if [e.alarm for e in scored2] != want2:
        print("[swap] FAIL: post-swap served alarms diverge from the composite "
              "old/new pipeline oracle")
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
