"""Rank bodies of ``tests/test_torch_distributed.py``.

A spawned rank imports this module (by its name on the test's
``sys.path``) and nothing else of the tests, so it imports only
``repro_torch``, torch and numpy: never JAX, never the JAX package,
never the test module. Each body takes numpy inputs made by the test
from seeds, runs a case on the mesh and its emulation in the same
process (so both see the same intra-op thread count), and returns CPU
tensors for the test to compare.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import ensemble, forest_trainer as ft, mapreduce as mr
from repro_torch.core import rotation_forest as rf
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serving import api
from repro_torch.signal import eeg_data, pipeline

N_RANKS = 2
FIT_FOREST = dict(n_trees=4, depth=3, n_bins=8)
PIPE_FOREST = dict(n_trees=2, depth=3, n_bins=8)
ENS_FOREST = dict(n_trees=2, n_subsets=3, depth=3, n_classes=2, n_bins=16)
REDUCERS = {"sum": mr.reduce_sum, "mean": mr.reduce_mean, "max": mr.reduce_max,
            "concat": mr.reduce_concat}
PROGRAM_DIR = str(Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "assets"
                  / "seizure_program")
# The mesh engine's cases: (overlap, megabatch, what else the case covers).
ENGINE_CASES = ((0, True, "snapshots"), (2, False, "snapshots"), (2, True, "latency budget"))
ENGINE_CUTS = (0, 37, 95, 151, 200, 240)  # chunk-unaligned push rounds (windows)
SNAP_ROUND = 3  # snapshots after this round's push, before its poll


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def features_of(x: torch.Tensor) -> torch.Tensor:
    """The fits' feature_fn: the raw rows and their magnitudes."""
    return torch.cat([x, x.abs()], dim=1)


def _mapreduce(mesh, rank: int, data: dict) -> dict:
    x = _t(data["reduce_x"])
    out = {}
    for name, red in REDUCERS.items():
        job = mr.MapReduce(lambda t: (t**2, t.sum()), red)
        out[name] = (job.run(mesh, x), job.run_local(N_RANKS, x))
    scale = torch.tensor(3.0)
    job = mr.MapReduce(lambda s, k: {"scaled": s * k, "total": (s * k).sum()}, mr.reduce_sum)
    out["replicated"] = (job.run(mesh, x, replicated_inputs=(scale,)),
                         job.run_local(N_RANKS, x, replicated_inputs=(scale,)))
    job = mr.MapReduce(lambda t: t.sum(dim=0), lambda parts: parts[0] - 2 * parts[-1])
    out["custom"] = (job.run(mesh, x), job.run_local(N_RANKS, x))
    try:  # rank r maps to r + 1 rows: the gather refuses on every rank
        mr.MapReduce(lambda t: t[: rank + 1]).run(mesh, x)
        out["mismatch"] = None
    except ValueError as exc:
        out["mismatch"] = str(exc)
    return out


def _shuffle(mesh, rank: int, data: dict) -> dict:
    out = {}
    for name, (values, keys) in data["shuffle"].items():
        out[name] = mr.shuffle_by_key(_t(values[rank]), _t(keys[rank]), mesh, N_RANKS)
    try:
        mr.shuffle_by_key(torch.zeros((5, 1)), torch.zeros(5, dtype=torch.int32), mesh, N_RANKS)
        out["ragged"] = None
    except ValueError as exc:
        out["ragged"] = str(exc)
    return out


def _fits(mesh, rank: int, data: dict) -> dict:
    x, y = _t(data["fit_x"]), _t(data["fit_y"])
    cfg = rf.RotationForestConfig(**FIT_FOREST)
    out = {
        "mesh": ft.fit_mapreduce(_gen(3), x, y, cfg, mesh=mesh, feature_fn=features_of),
        "local": ft.fit_mapreduce(_gen(3), x, y, cfg, n_shards=N_RANKS, feature_fn=features_of),
    }
    feats = _t(data["moment_feats"])
    mine = feats.chunk(N_RANKS)[rank]
    out["moments"] = (ft.global_moments(mine, mesh=mesh),
                      ft.global_moments(list(feats.chunk(N_RANKS))))
    # A one-rank mesh over rank 0 (every rank takes part in making its group).
    one = DeviceMesh("cpu", [0], mesh_dim_names=("data",))
    if rank == 0:
        out["one"] = (ft.fit_mapreduce(_gen(4), x, y, cfg, mesh=one, feature_fn=features_of),
                      ft.fit_mapreduce(_gen(4), x, y, cfg, n_shards=1, feature_fn=features_of))
    return out


def _pipeline(mesh, rank: int, data: dict) -> dict:
    rec = eeg_data.Recording(_t(data["rec_windows"]), _t(data["rec_labels"]))
    cfg = pipeline.PipelineConfig(forest=rf.RotationForestConfig(**PIPE_FOREST))
    per_shard = [pipeline.process_windows(w, cfg) for w in rec.windows.chunk(N_RANKS)]
    return {
        "fit": (pipeline.fit(_gen(5), rec, cfg, mesh=mesh),
                pipeline.fit(_gen(5), rec, cfg, n_shards=N_RANKS)),
        "features": (pipeline.process_recording_mapreduce(mesh, rec, cfg),
                     torch.cat(per_shard)),
    }


def _ensemble(mesh, rank: int, data: dict) -> dict:
    x, y = _t(data["ens_x"]), _t(data["ens_y"])
    cfg = rf.RotationForestConfig(**ENS_FOREST)
    ens = ensemble.DistributedEnsemble(
        fit_fn=lambda g, xs, ys: rf.fit(g, xs, ys, cfg), predict_fn=rf.predict_proba
    )
    members = ens.fit(mesh, _gen(6), x, y)
    logits = _t(data["logits"])
    return {
        "members": (members, ens.fit_local(N_RANKS, _gen(6), x, y)),
        "accuracy": float((ens.predict(members, x) == y).float().mean()),
        "vote": (ensemble.ensemble_vote(logits[rank], mesh),
                 mr.reduce_mean([torch.softmax(lg, dim=-1) for lg in logits])),
    }


def _engine_program(overlap: int) -> api.ScoringProgram:
    """The committed program at ``overlap`` under a 1-of-1 alarm rule, so
    the streams raise and clear alarms."""
    program = api.ScoringProgram.load(PROGRAM_DIR, device="cpu")
    return dataclasses.replace(
        program, cfg=program.cfg._replace(overlap=overlap, alarm_k=1, alarm_m=1))


def _retrained(program: api.ScoringProgram) -> api.ScoringProgram:
    """A program of the same shapes that votes differently: the one
    ``swap_program`` installs mid-stream."""
    return dataclasses.replace(program, feat_mean=program.feat_mean + 0.25 * program.feat_std)


def _serve_head(engine, streams: dict, snapshot=None) -> list:
    """Open every session and run the push rounds up to the push of
    SNAP_ROUND (calling ``snapshot(engine)`` there), polling without
    draining after each round; every alarm is reset after round 1 and a
    retrained program is swapped in after round 2."""
    for pid in streams:
        engine.open_session(pid)
    events = []
    for r, (lo, hi) in enumerate(zip(ENGINE_CUTS[:-1], ENGINE_CUTS[1:])):
        for pid, stream in streams.items():
            engine.session(pid).push(stream[lo:hi])
        if r == SNAP_ROUND:
            if snapshot is not None:
                snapshot(engine)
            return events
        events += engine.poll(drain=False)
        if r == 1:
            for pid in streams:
                engine.reset_alarm(pid)
        if r == 2:
            engine.swap_program(_retrained(engine.program))
    raise AssertionError("SNAP_ROUND is past the last round")


def _serve_tail(engine, streams: dict) -> list:
    """The rounds after the snapshot point, then a draining poll."""
    events = engine.poll(drain=False)
    for lo, hi in zip(ENGINE_CUTS[SNAP_ROUND + 1:-1], ENGINE_CUTS[SNAP_ROUND + 2:]):
        for pid, stream in streams.items():
            engine.session(pid).push(stream[lo:hi])
        events += engine.poll(drain=False)
    return events + engine.poll()


def _ticking(step: float):
    """A clock that moves ``step`` seconds at every read."""
    now = [0.0]

    def clock():
        now[0] += step
        return now[0]

    return clock


def _engine(mesh, rank: int, data: dict) -> dict:
    """The mesh engine against the unsharded engine in this process, over
    ENGINE_CASES. Snapshot cases also resume a mesh snapshot without a
    mesh and an unsharded one (rank 0's) on the mesh. In the latency case
    only rank 1's clock ever passes the mesh engine's budget, so the
    unsharded engine flushes every partial batch (budget 0) and the mesh
    engine must too."""
    streams = data["engine_streams"]
    out = {}
    for overlap, megabatch, extra in ENGINE_CASES:
        program = _engine_program(overlap)
        kw = dict(max_batch=2, replay_depth=2, megabatch=megabatch, device="cpu")
        case = out[f"overlap{overlap}_megabatch{megabatch}"] = {}
        plain_kw, mesh_kw = dict(kw), dict(kw, mesh=mesh)
        if extra == "latency budget":
            plain_kw["latency_budget_s"] = 0.0
            mesh_kw.update(latency_budget_s=50.0, clock=_ticking(100.0 if rank else 0.0))
        snap_dir = os.path.join(data["engine_dir"], f"overlap{overlap}_{megabatch}")
        snaps = extra == "snapshots"
        plain = api.SeizureEngine(program, **plain_kw)
        head = _serve_head(plain, streams, snapshot=(
            (lambda e: e.snapshot(os.path.join(snap_dir, "plain"), 4) if rank == 0 else None)
            if snaps else None))
        case["plain"] = head + _serve_tail(plain, streams)
        engine = api.SeizureEngine(program, **mesh_kw)
        head = _serve_head(engine, streams, snapshot=(
            (lambda e: e.snapshot(os.path.join(snap_dir, "mesh"), 4)) if snaps else None))
        tail = _serve_tail(engine, streams)
        case["mesh"] = head + tail
        case["mesh_slots"] = tuple(engine._state.rings.shape)
        if snaps:
            dist.barrier()  # rank 0's unsharded snapshot is written
            restored = api.SeizureEngine.restore(os.path.join(snap_dir, "mesh"), device="cpu")
            case["mesh_snapshot_unsharded"] = (len(head), _serve_tail(restored, streams))
            restored = api.SeizureEngine.restore(os.path.join(snap_dir, "plain"), mesh=mesh,
                                                 device="cpu")
            case["plain_snapshot_on_mesh"] = (len(head), _serve_tail(restored, streams))
    program = _engine_program(0)
    chunks = np.stack([s[:eeg_data.WINDOWS_PER_MATRIX] for s in streams.values()])
    engine = api.SeizureEngine(program, max_batch=2, mesh=mesh, device="cpu")
    out["score_chunks"] = (engine.score_chunks(chunks[:2]),
                           api.SeizureEngine(program, max_batch=2, device="cpu")
                           .score_chunks(chunks[:2]))
    for name, call in (("max_batch", lambda: api.SeizureEngine(program, max_batch=3, mesh=mesh,
                                                                device="cpu")),
                       ("score_chunks", lambda: engine.score_chunks(chunks))):
        try:
            call()
            out[f"{name}_error"] = None
        except ValueError as exc:
            out[f"{name}_error"] = str(exc)
    return out


def fail_or_hang(rank: int, device: torch.device) -> None:
    """Rank 0 fails at once; rank 1 would wait far past any test's limit."""
    if rank == 0:
        raise ValueError("rank 0 fails")
    time.sleep(600.0)


def all_cases(rank: int, device: torch.device, data: dict) -> dict:
    """Every case of the test file on one world of N_RANKS gloo CPU ranks."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_host_mesh(data=N_RANKS, device_type=device.type)
    return {
        "mapreduce": _mapreduce(mesh, rank, data),
        "shuffle": _shuffle(mesh, rank, data),
        "fits": _fits(mesh, rank, data),
        "pipeline": _pipeline(mesh, rank, data),
        "ensemble": _ensemble(mesh, rank, data),
        "engine": _engine(mesh, rank, data),
    }
