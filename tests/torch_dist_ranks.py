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

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import ensemble, forest_trainer as ft, mapreduce as mr
from repro_torch.core import rotation_forest as rf
from repro_torch.launch import mesh as mesh_lib
from repro_torch.signal import eeg_data, pipeline

N_RANKS = 2
FIT_FOREST = dict(n_trees=4, depth=3, n_bins=8)
PIPE_FOREST = dict(n_trees=2, depth=3, n_bins=8)
ENS_FOREST = dict(n_trees=2, n_subsets=3, depth=3, n_classes=2, n_bins=16)
REDUCERS = {"sum": mr.reduce_sum, "mean": mr.reduce_mean, "max": mr.reduce_max,
            "concat": mr.reduce_concat}


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
    }
