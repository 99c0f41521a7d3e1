"""Streaming seizure-scoring demo in the PyTorch port: continuous
multi-patient sessions (the twin of ``examples/serve_seizure.py``).

Trains a rotation forest on synthetic Freiburg-like EEG, freezes it into
a ``ScoringProgram``, then streams raw windows from several patients
through one ``serving.api.SeizureEngine``. Pushes are not chunk-aligned
(each session assembles the paper's 60-window chunks itself), slots are
refilled mid-flight as sessions drain, and the k-of-m alarm rule runs on
the device inside the scoring step; typed events (ChunkScored /
AlarmRaised / AlarmCleared) come back from ``poll``. On the card the fit
runs K2, K3 (its features) and K4 (its grower), and every engine step K1
(the votes), K2 and K3 (MSPCA and the WPD tree).

  PYTHONPATH=src python examples/serve_seizure_torch.py --patients 2 --batch 4
  PYTHONPATH=src python examples/serve_seizure_torch.py --patients 2 --batch 4 --device cpu

The reference's ``--use-forest-kernel`` is gone: the port routes the
forest traversal by the device its tensors lie on, so an engine on the
card always runs K1 and one on the CPU its plain version (the JAX flag
chose the Pallas kernel, in interpret mode off the TPU, which has no
counterpart here). The EEG comes from the port's ``signal/eeg_data.py``
through ``torch.Generator``s seeded as the reference seeds its keys (0
and 1 for the training set and the fit, 100 + patient for each stream):
the reference's generative model, other draws, so the numbers agree with
the JAX example's only in their statistics.

``train_program``, ``make_streams`` and ``serve`` are the steps; ``serve``
returns its results as plain Python and numpy, and ``main`` prints the
reference's lines and a final ``json`` line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import rotation_forest as rf
from repro_torch.device import resolve_device
from repro_torch.serving import AlarmRaised, ChunkScored, ScoringProgram, SeizureEngine
from repro_torch.signal import eeg_data, pipeline


def train_program(*, overlap: int = 0, save_dir: str | None = None,
                  device: str | torch.device = "cuda", log=print) -> ScoringProgram:
    """The demo's forest (8 trees of depth 5, 16 bins) fitted on patient 0's
    60 + 60 training windows, frozen into a program (and round-tripped
    through the checkpoint store under ``save_dir``, if given)."""
    dev = resolve_device(device)
    cfg = pipeline.PipelineConfig(
        forest=rf.RotationForestConfig(n_trees=8, n_subsets=3, depth=5, n_classes=2, n_bins=16),
        overlap=overlap,
    )
    # One forest serves all patients here (the paper trains per patient;
    # swap in per-patient programs + one engine per program).
    rec = eeg_data.make_training_set(torch.Generator(device=dev).manual_seed(0), 0, 60, 60)
    fitted = pipeline.fit(torch.Generator(device=dev).manual_seed(1), rec, cfg)
    program = ScoringProgram.from_fitted(fitted, cfg)
    if save_dir:
        path = program.save(save_dir)
        program = ScoringProgram.load(save_dir, device=dev)
        log(f"round-tripped ScoringProgram through {path}")
    return program


def make_streams(patients: int, hours_interictal: int = 1, *,
                 device: str | torch.device = "cuda") -> dict[int, np.ndarray]:
    """Each patient's test timeline (``hours_interictal`` hours, the
    48-minute run-up, the seizure) as host windows, keyed by patient."""
    dev = resolve_device(device)
    return {pid: eeg_data.make_test_timeline(
                torch.Generator(device=dev).manual_seed(100 + pid), pid,
                hours_interictal=hours_interictal, minutes_preictal=48,
            ).windows.cpu().numpy()
            for pid in range(patients)}


def serve(program: ScoringProgram, streams: dict[int, np.ndarray], *, batch: int = 4,
          push_windows: int = 25, replay_depth: int = 4, latency_budget: float | None = None,
          device: str | torch.device = "cuda", log=print) -> dict:
    """Stream every patient's windows through one engine, ``push_windows``
    at a time for each patient in turn, polling after every round
    (draining each poll unless a latency budget defers partial batches),
    then a final draining poll. Returns the events in order, each
    patient's chunk votes and alarms as served, the final alarm states,
    the chunks scored, the engine steps and the wall seconds."""
    dev = resolve_device(device)
    engine = SeizureEngine(program, max_batch=batch, replay_depth=replay_depth,
                           latency_budget_s=latency_budget, device=dev)
    for pid in streams:
        engine.open_session(pid)
    n_windows = sum(s.shape[0] for s in streams.values())
    log(f"serving {len(streams)} patients, {n_windows} total 8s windows "
        f"(batch {batch}, pushes of {push_windows} windows)")
    events: list = []
    t0 = time.perf_counter()

    def handle(new) -> None:
        events.extend(new)
        for event in new:
            if isinstance(event, AlarmRaised):
                log(f"  *** ALARM *** patient {event.patient_id} "
                    f"at chunk {event.chunk_index} (t={event.chunk_index * 8}min)")
            elif isinstance(event, ChunkScored) and event.chunk_pred:
                log(f"  t={event.chunk_index * 8:4d}min patient {event.patient_id}: "
                    f"preictal_frac={event.preictal_frac:.2f} "
                    f"vote={event.chunk_pred} alarm={event.alarm}")

    # With a latency budget, defer partial batches (the budget bounds how
    # long a lone chunk can wait); without one, drain every poll.
    drain_each = latency_budget is None
    offset = 0
    while any(offset < s.shape[0] for s in streams.values()):
        for pid, wins in streams.items():
            engine.session(pid).push(wins[offset:offset + push_windows])
        offset += push_windows
        handle(engine.poll(drain=drain_each))
    handle(engine.poll())  # final drain of any deferred partial batch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    scored = [e for e in events if isinstance(e, ChunkScored)]
    windows = len(scored) * eeg_data.WINDOWS_PER_MATRIX
    log(f"scored {len(scored)} chunks ({windows} windows) in {dt:.1f}s "
        f"-> {windows / dt:.0f} windows/s "
        f"({engine.steps} engine steps, replay depth {replay_depth})")
    final = {pid: engine.alarm_state(pid) for pid in streams}
    for pid, state in final.items():
        log(f"patient {pid}: final alarm state = {state}")
    per_patient = {pid: {"chunk_preds": [e.chunk_pred for e in scored if e.patient_id == pid],
                         "alarms": [e.alarm for e in scored if e.patient_id == pid]}
                   for pid in streams}
    return {"events": events, "served": per_patient, "final_alarms": final,
            "chunks": len(scored), "steps": engine.steps, "seconds": dt,
            "windows_per_s": windows / dt}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--patients", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--hours-interictal", type=int, default=1)
    ap.add_argument("--push-windows", type=int, default=25,
                    help="windows per push (deliberately chunk-unaligned)")
    ap.add_argument("--save-dir", default=None,
                    help="optionally round-trip the ScoringProgram "
                         "through the checkpoint store")
    ap.add_argument("--replay-depth", type=int, default=4,
                    help="backlogged chunks one engine step replays per "
                         "slot (catch-up bursts score up to this many "
                         "chunks per step)")
    ap.add_argument("--latency-budget", type=float, default=None,
                    help="seconds before a partial batch is flushed "
                         "anyway under poll(drain=False)")
    ap.add_argument("--overlap", type=int, default=0,
                    help="cross-chunk MSPCA halo windows (0 = the "
                         "paper's fully independent chunk denoise)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    program = train_program(overlap=args.overlap, save_dir=args.save_dir, device=args.device)
    streams = make_streams(args.patients, args.hours_interictal, device=args.device)
    res = serve(program, streams, batch=args.batch, push_windows=args.push_windows,
                replay_depth=args.replay_depth, latency_budget=args.latency_budget,
                device=args.device)
    keys = ("served", "final_alarms", "chunks", "steps", "seconds", "windows_per_s")
    print(json.dumps({k: res[k] for k in keys}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
