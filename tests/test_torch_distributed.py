"""The port's mesh mode (``torch.distributed``) on the CPU:
``MapReduce.run``, ``shuffle_by_key``, ``fit_mapreduce(mesh=)``,
``global_moments``, ``pipeline.fit(mesh=)``,
``process_recording_mapreduce``, ``DistributedEnsemble``, the launcher's
``--devices``, ``SeizureEngine(mesh=)``, the mesh Model (reduced dense and
moe configs on (1, 2) and (2, 1) meshes), ``BatchStream(shardings=)`` and
the LM ensemble over ranks, against their emulations (the unsharded
engine and model) and the JAX package.

One world of two gloo CPU ranks (``launch.mesh.spawn_world``) runs every
case once for the whole file (``tests/torch_dist_ranks.py``, which
imports only ``repro_torch``); the one-rank cases run on a one-rank
group of the same world. The launcher case starts the file's second and
last world; one rank's body also runs here, in a world of one. Inputs are made here with numpy from seeds (the ensemble's
from the reference's own blobs) and handed to the ranks as numpy.

Tolerances:
  * mesh against emulation: bit for bit in every leaf (the mesh gathers
    each leaf and folds it in rank order with the emulation's reducers).
  * ``run`` against the JAX ``run_local``: 1e-6 (as
    ``test_run_local_reducers_match_jax``: other summation order).
  * ``shuffle_by_key`` against the JAX function under ``vmap``: exact.
  * global moments: 1e-5 of max|want| (as ``test_global_moments_match_jax``).
  * features: 2e-3 z-units (the port's feature tests; MSPCA's eigh).
  * ensemble probabilities on converted members: 1e-6.
  * the mesh engine against the unsharded engine in the same rank (one
    intra-op thread each): every event field, ``preictal_frac`` and the
    window predictions included, bit for bit.
  * the mesh Model against the unsharded one: LM_MESH_TOL (1e-5) on
    float32 logits; one train step as ``test_mesh_train_step_equals_
    unsharded`` states; the batch stream and the LM ensemble bit for bit.
"""

from __future__ import annotations

import ast
import pickle
import queue
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_ranks as ranks
from repro.core import ensemble as jensemble
from repro.core import forest_trainer as jft
from repro.core import mapreduce as jmr
from repro.core import rotation_forest as jrf
from repro.signal import pipeline as jpipeline
from repro_torch import convert
from repro_torch.core import ensemble, forest_trainer as ft, mapreduce as mr
from repro_torch.core import rotation_forest as rf
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train_forest
from repro_torch.serving import api
from repro_torch.signal import eeg_data

# One intra-op thread, as the ranks use: the emulations computed here
# then sum in the ranks' order.
torch.set_num_threads(1)

N = ranks.N_RANKS
JAX_REDUCERS = {"sum": jmr.reduce_sum, "mean": jmr.reduce_mean, "max": jmr.reduce_max,
                "concat": jmr.reduce_concat}
# The reference's two shuffle cases (tests/test_core.py), 2 shards x 4 rows.
SHUFFLES = {
    "balanced": (np.arange(8.0, dtype=np.float32).reshape(2, 4, 1),
                 np.array([[0, 1, 0, 1], [1, 0, 1, 0]], np.int32)),
    "overflow": (np.array([[1.0, 2.0, 3.0, 4.0], [10.0, 20.0, 30.0, 40.0]], np.float32)[..., None],
                 np.array([[0, 0, 0, 1], [0, 1, 0, 1]], np.int32)),
}


def _blobs(seed: int, n: int, f: int, informative: int, shift: float):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n).astype(np.int32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[:, :informative] += shift * (2 * y[:, None] - 1)
    return x, y


def _reference_blobs():
    """tests/test_core.py's ``blobs``: 400 rows of 12, two classes at +-2."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    x = jnp.concatenate([jax.random.normal(k1, (200, 12)) + 2.0,
                         jax.random.normal(k2, (200, 12)) - 2.0])
    y = jnp.concatenate([jnp.zeros(200, jnp.int32), jnp.ones(200, jnp.int32)])
    perm = jax.random.permutation(k3, 400)
    return np.array(x[perm]), np.array(y[perm])


def _engine_streams() -> dict:
    """Three patients' streams of 4 chunks, from a generator of their own:
    each turns preictal or back, so the 1-of-1 rule raises and clears."""
    g = torch.Generator().manual_seed(31)
    inter, pre = eeg_data.INTERICTAL, eeg_data.PREICTAL
    plan = {3: [(inter, 120), (pre, 120)], 8: [(pre, 120), (inter, 120)],
            13: [(inter, 60), (pre, 120), (inter, 60)]}
    return {pid: torch.cat([eeg_data.generate_windows(g, pid, r, n) for r, n in parts]).numpy()
            for pid, parts in plan.items()}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(11)
    fit_x, fit_y = _blobs(7, 120, 12, 3, 1.6)
    rec = eeg_data.make_training_set(torch.Generator().manual_seed(21), 3, 60, 60)
    ens_x, ens_y = _reference_blobs()
    return {
        "reduce_x": rng.normal(size=(12, 5)).astype(np.float32),
        "shuffle": SHUFFLES,
        "fit_x": fit_x, "fit_y": fit_y,
        "moment_feats": _blobs(8, 240, 288, 12, 1.0)[0] * 40.0 + 500.0,
        "rec_windows": rec.windows.numpy(), "rec_labels": rec.labels.numpy(),
        "ens_x": ens_x, "ens_y": ens_y,
        "logits": rng.normal(size=(N, 6, 3)).astype(np.float32),
        "engine_streams": _engine_streams(),
        "engine_dir": str(tmp_path_factory.mktemp("mesh_engine")),
    }


@pytest.fixture(scope="module")
def world(data):
    """Every rank's results of ``torch_dist_ranks.all_cases``."""
    return mesh_lib.spawn_world(
        ranks.all_cases, N, backend="gloo", device="cpu", args=(data,), timeout_s=300.0
    ).check()


def _bit_equal(a, b) -> None:
    la, lb = mr._leaves(a), mr._leaves(b)
    assert len(la) == len(lb)
    for u, v in zip(la, lb):
        assert u.dtype == v.dtype and u.shape == v.shape
        assert torch.equal(u, v)


# ---------------------------------------------------------------------------
# MapReduce.run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(JAX_REDUCERS))
def test_run_equals_run_local_and_jax(world, data, name):
    x = data["reduce_x"]
    want = jmr.MapReduce(lambda t: (t**2, jnp.sum(t)), JAX_REDUCERS[name]).run_local(
        N, jnp.asarray(x))
    for rank in range(N):
        got, local = world[rank]["mapreduce"][name]
        _bit_equal(got, local)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_run_with_replicated_inputs(world, data):
    x = data["reduce_x"]
    want = jmr.MapReduce(
        lambda s, k: {"scaled": s * k, "total": jnp.sum(s * k)}, jmr.reduce_sum
    ).run_local(N, jnp.asarray(x), replicated_inputs=(jnp.asarray(3.0),))
    for rank in range(N):
        got, local = world[rank]["mapreduce"]["replicated"]
        _bit_equal(got, local)
        for k in ("scaled", "total"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)


def test_run_with_a_custom_reducer_and_mismatched_leaves(world, data):
    x = torch.from_numpy(data["reduce_x"])
    for rank in range(N):
        got, local = world[rank]["mapreduce"]["custom"]
        _bit_equal(got, local)
        assert torch.equal(got, x[:6].sum(dim=0) - 2 * x[6:].sum(dim=0))
        assert "differ across ranks" in world[rank]["mapreduce"]["mismatch"]


# ---------------------------------------------------------------------------
# shuffle_by_key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(SHUFFLES))
def test_shuffle_by_key_equals_jax(world, case):
    values, keys = SHUFFLES[case]
    want = np.asarray(jax.vmap(
        lambda v, k: jmr.shuffle_by_key(v, k, "data", N), axis_name="data"
    )(jnp.asarray(values), jnp.asarray(keys)))
    local = mr.shuffle_by_key_local(
        [torch.from_numpy(v) for v in values], [torch.from_numpy(k) for k in keys], N)
    for rank in range(N):
        np.testing.assert_array_equal(world[rank]["shuffle"][case].numpy(), want[rank])
        np.testing.assert_array_equal(local[rank].numpy(), want[rank])
    if case == "overflow":  # the overflow row 3.0 is dropped, not misrouted
        assert 3.0 not in want.ravel().tolist()


def test_shuffle_by_key_rejects_ragged_rows(world):
    for rank in range(N):
        assert "not divisible" in world[rank]["shuffle"]["ragged"]
    with pytest.raises(ValueError, match="not divisible"):
        mr.shuffle_by_key_local([torch.zeros((5, 1))] * 2, [torch.zeros(5)] * 2, 2)


# ---------------------------------------------------------------------------
# fit_mapreduce, global_moments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_ranks", [2, 1])
def test_fit_mapreduce_mesh_equals_n_shards(world, data, n_ranks):
    """A mesh of S ranks returns n_shards=S's fit in every leaf, bit for
    bit, on every rank (and equals the emulation run here)."""
    cfg = rf.RotationForestConfig(**ranks.FIT_FOREST)
    x, y = torch.from_numpy(data["fit_x"]), torch.from_numpy(data["fit_y"])
    if n_ranks == 2:
        pairs = [(world[r]["fits"]["mesh"], world[r]["fits"]["local"]) for r in range(N)]
        here = ft.fit_mapreduce(torch.Generator().manual_seed(3), x, y, cfg, n_shards=2,
                                feature_fn=ranks.features_of)
    else:
        pairs = [world[0]["fits"]["one"]]
        here = ft.fit_mapreduce(torch.Generator().manual_seed(4), x, y, cfg, n_shards=1,
                                feature_fn=ranks.features_of)
        assert "one" not in world[1]["fits"]
    for got, local in pairs:
        _bit_equal(got, local)
        _bit_equal(got, here)
        assert got.forest.rotation.shape == (4, 24, 24)


def test_global_moments_on_a_mesh_match_jax(world, data):
    feats = data["moment_feats"]
    want = jax.vmap(lambda f: jft.global_moments(f, "data"), axis_name="data")(
        jnp.asarray(feats.reshape(N, -1, feats.shape[1])))
    for rank in range(N):
        got, local = world[rank]["fits"]["moments"]
        _bit_equal(got, local)
        for g, w in zip(got, want):
            w = np.asarray(w[0])
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


# ---------------------------------------------------------------------------
# pipeline.fit(mesh=), process_recording_mapreduce
# ---------------------------------------------------------------------------

def test_pipeline_fit_on_a_mesh_equals_n_shards(world):
    """Denoise on, one whole 8-minute chunk per rank."""
    for rank in range(N):
        got, local = world[rank]["pipeline"]["fit"]
        _bit_equal(got, local)
        assert got.feat_mean.shape == (288,) and got.forest.rotation.shape[0] == 2


def test_process_recording_mapreduce_matches_jax(world, data):
    want = np.asarray(jpipeline.process_windows(
        jnp.asarray(data["rec_windows"]), jpipeline.PipelineConfig()))
    for rank in range(N):
        got, per_shard = world[rank]["pipeline"]["features"]
        assert torch.equal(got, per_shard) and got.shape == (120, 288)
        z = np.abs(got.numpy() - want) / (want.std(0) + 1e-6)
        assert float(z.max()) <= 2e-3


# ---------------------------------------------------------------------------
# DistributedEnsemble, ensemble_vote
# ---------------------------------------------------------------------------

def test_ensemble_fit_on_a_mesh_equals_fit_local(world, data):
    for rank in range(N):
        got, local = world[rank]["ensemble"]["members"]
        _bit_equal(got, local)
        assert got.rotation.shape == (N, 2, 12, 12)  # members x trees
        assert world[rank]["ensemble"]["accuracy"] > 0.95
        vote, want = world[rank]["ensemble"]["vote"]
        assert torch.equal(vote, want)
        np.testing.assert_allclose(vote.sum(-1).numpy(), 1.0, atol=1e-6)


def test_ensemble_predict_proba_matches_jax(data):
    """The port's vote on members fitted by the JAX package's fit_local."""
    cfg = jrf.RotationForestConfig(**ranks.ENS_FOREST)
    jens = jensemble.DistributedEnsemble(
        fit_fn=lambda k, xs, ys: jrf.fit(k, xs, ys, cfg), predict_fn=jrf.predict_proba)
    x, y = jnp.asarray(data["ens_x"]), jnp.asarray(data["ens_y"])
    members = jens.fit_local(N, jax.random.PRNGKey(0), x, y)
    want = np.asarray(jens.predict_proba(members, x))
    ens = ensemble.DistributedEnsemble(fit_fn=None, predict_fn=rf.predict_proba)
    got = ens.predict_proba(convert.forest_from_jax(members, device="cpu"),
                            torch.from_numpy(data["ens_x"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert float((ens.predict(convert.forest_from_jax(members, device="cpu"),
                              torch.from_numpy(data["ens_x"])).numpy() == data["ens_y"]).mean()) > 0.95


# ---------------------------------------------------------------------------
# SeizureEngine(mesh=)
# ---------------------------------------------------------------------------

def _assert_identical(got, want) -> None:
    """Every event field equal, bit for bit (``preictal_frac`` included)."""
    assert [type(e).__name__ for e in got] == [type(e).__name__ for e in want]
    for g, w in zip(got, want):
        if isinstance(w, api.ChunkScored):
            assert g[:5] + (g.program_version,) == w[:5] + (w.program_version,)
            np.testing.assert_array_equal(g.window_preds, w.window_preds)
        else:
            assert tuple(g) == tuple(w)


@pytest.mark.parametrize("overlap,megabatch,extra", ranks.ENGINE_CASES)
def test_mesh_engine_equals_unsharded(world, overlap, megabatch, extra):
    """Two slots over two ranks, three sessions (evictions), every alarm
    reset after round 1 and a program swapped in after round 2: the mesh
    engine emits the unsharded engine's events on every rank. Snapshot
    cases resume a mesh snapshot without a mesh and an unsharded snapshot
    on the mesh; in the latency case one rank's clock decides for both."""
    for rank in range(N):
        case = world[rank]["engine"][f"overlap{overlap}_megabatch{megabatch}"]
        plain, mesh = case["plain"], case["mesh"]
        _assert_identical(mesh, plain)
        _assert_identical(mesh, world[0]["engine"][f"overlap{overlap}_megabatch{megabatch}"]["mesh"])
        kinds = [type(e).__name__ for e in plain]
        assert kinds.count("ChunkScored") == 12
        assert "AlarmRaised" in kinds and "AlarmCleared" in kinds
        assert {e.program_version for e in plain if isinstance(e, api.ChunkScored)} == {0, 1}
        assert case["mesh_slots"] == (1, 1)  # this rank's one slot of two, a ring of 1
        if extra == "snapshots":
            for key in ("mesh_snapshot_unsharded", "plain_snapshot_on_mesh"):
                n_head, tail = case[key]
                assert 0 < n_head < len(mesh)
                _assert_identical(tail, mesh[n_head:])


def test_mesh_engine_score_chunks_and_indivisible_batches(world):
    for rank in range(N):
        out = world[rank]["engine"]
        (got, want) = out["score_chunks"]
        for g, w in zip(got, want):
            assert g.shape[0] == 2 and torch.equal(g, w)
        assert "not divisible by mesh data axis 2" in out["max_batch_error"]
        assert "does not split over mesh data axis 2" in out["score_chunks_error"]


# ---------------------------------------------------------------------------
# The mesh Model (sharding rules as DTensor placements), BatchStream,
# the ensemble over ranks
# ---------------------------------------------------------------------------

# float32 logits of a reduced model: the mesh sums tensor-parallel partials
# and splits the softmax's reductions across ranks, in another order than
# one process: a few ulps of O(1) values.
LM_MESH_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ranks.LM_ARCHS)
@pytest.mark.parametrize("shape", ranks.LM_MESHES)
def test_mesh_model_equals_unsharded(world, arch, shape):
    """Forward logits of a reduced dense and moe model on a (1, 2) mesh
    (tensor parallel: half the heads and experts a rank) and a (2, 1) mesh
    (rows over 'data') against the unsharded model, on every rank; for the
    dense model on (1, 2) also a prefill's last logits and one decode step
    (its one KV head leaves the cache's sequence split over 'model', so
    each rank writes and reads its shard and the softmax is split)."""
    for rank in range(N):
        case = world[rank]["lm_mesh"][f"{arch} {shape}"]
        for what in ("forward", "prefill", "decode"):
            if what not in case:
                assert (arch, shape) != (ranks.LM_ARCHS[0], (1, 2))
                continue
            got, want = case[what]
            np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=what, **LM_MESH_TOL)
        assert case["local_rows"][0] == 4 // shape[0]


def test_context_parallel_and_seq_shard_equal_unsharded(world):
    """``build(context_parallel=True, seq_shard=True)`` on a (1, 2) mesh:
    the chunked attention's two query chunks of S = 2048 split over the
    model ranks, the residual stream's sequence split between blocks; the
    logits within LM_MESH_TOL of the unsharded model's."""
    for rank in range(N):
        got, want = world[rank]["lm_mesh"]["context_parallel"]
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LM_MESH_TOL)


def test_mesh_train_step_equals_unsharded(world):
    """One AdamW step (2 microbatches) under the fsdp rules on a (2, 1)
    mesh against the unsharded step. The loss within 1e-6 relative. The
    clipped gradients (the first step's m / (1 - b1)), which carry the
    FSDP gathers' reduce-scatters, leaf by leaf within 1e-5 of the leaf's
    largest |g|: float32 sums of the same rows in another order (the worst
    leaf measured 2.5e-7 of its scale, blocks.attn.wk). The
    parameters: AdamW's first update is lr x sign(g) wherever |g| >> eps,
    so a gradient within rounding of 0 may take the other sign: every
    element within 2 lr of the unsharded step, and all but 1% of each
    leaf's within 1e-6."""
    for rank in range(N):
        case = world[rank]["lm_mesh"]["train"]
        got, want = case["loss"]
        assert float(got) == pytest.approx(float(want), rel=1e-6)
        assert "Shard(dim=0)" in case["placements"]
        for name, (g, w) in case["grads"].items():
            scale = float(w.abs().max())
            assert scale > 0, name
            assert float((g - w).abs().max()) <= 1e-5 * scale, name
        for name, (g, w) in case["params"].items():
            diff = (g - w).abs()
            assert float(diff.max()) <= 2 * ranks.LM_LR + 1e-6, name
            assert float((diff > 1e-6).float().mean()) <= 0.01, name


def test_batch_stream_shardings(world):
    """``BatchStream(shardings=(mesh, batch_pspecs))``: each rank holds its
    rows of the same draw, bit for bit."""
    for rank in range(N):
        for name, (got, want) in world[rank]["lm_mesh"]["stream"].items():
            assert torch.equal(got, want), name


def test_ensemble_step_over_two_ranks_equals_one_process(world):
    """``ensemble_init(mesh=)`` draws each rank's member as the one-process
    ensemble draws it (``shard_generators``, ``fit_local``'s draw), and
    ``make_ensemble_train_step(mesh=)`` steps it as the one-process step
    does: members, losses and steps bit for bit."""
    for rank in range(N):
        case = world[rank]["lm_ensemble"]
        for group in ("drawn", "stepped"):
            for name, (got, want) in case[group].items():
                assert torch.equal(got, want), (group, name)
        for what in ("loss", "step"):
            got, want = case[what]
            assert torch.equal(got, want), what
    assert not torch.equal(world[0]["lm_ensemble"]["drawn"]["embed"][0],
                           world[1]["lm_ensemble"]["drawn"]["embed"][0])


# ---------------------------------------------------------------------------
# The launcher, the backends, the world
# ---------------------------------------------------------------------------

def test_train_forest_launcher_on_a_gloo_mesh(tmp_path, capfd):
    rc = train_forest.main([
        "--device", "cpu", "--devices", "2", "--backend", "gloo", "--trees", "2",
        "--depth", "3", "--bins", "8", "--train-chunks", "2", "--hours-interictal", "0",
        "--batch", "1", "--replay-depth", "1", "--save-dir", str(tmp_path),
    ])
    out = capfd.readouterr().out
    assert rc == 0, out
    assert "gloo mesh" in out and "served alarms == pipeline oracle" in out
    assert "composite oracle" in out and out.count("[train]") == 1  # rank 0 prints


def test_backends_are_explicit():
    with pytest.raises(ValueError, match="gloo"):  # more nccl ranks than cards
        mesh_lib.spawn_world(ranks.all_cases, 2, backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="gloo"):
        train_forest.main(["--device", "cpu", "--devices", "2", "--backend", "nccl"])
    with pytest.raises(SystemExit):
        train_forest.main(["--device", "cpu", "--devices", "2"])
    with pytest.raises(ValueError, match="backend"):
        mesh_lib.spawn_world(ranks.all_cases, 2, backend="mpi", device="cpu")
    with pytest.raises(RuntimeError, match="initialized"):
        mesh_lib.make_host_mesh(2)
    failed = mesh_lib.WorldResult([0, None], {1: "Traceback ...\nValueError: boom"})
    assert failed.returncode == 1
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        failed.check()


def _boom(rank, device):
    raise ValueError(f"boom on rank {rank} ({device})")


def _doubled(rank, device, x):
    return {"x": 2 * x, "backend": dist.get_backend()}


def test_a_rank_reports_its_result_or_its_traceback(monkeypatch):
    """One rank's body in this process (a world of one, no spawn): its
    result comes back pickled, its exception as its traceback, re-raised,
    and the group is gone either way."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    results = queue.Queue()
    mesh_lib._rank_main(0, 1, "gloo", "cpu", 1, store.port, 60.0, _doubled,
                        (torch.arange(3.0),), results)
    rank, ok, payload = results.get_nowait()
    out = pickle.loads(payload)
    assert (rank, ok, out["backend"]) == (0, True, "gloo")
    assert torch.equal(out["x"], torch.tensor([0.0, 2.0, 4.0]))
    with pytest.raises(ValueError, match="boom on rank 0"):
        mesh_lib._rank_main(0, 1, "gloo", "cpu", 1, store.port, 60.0, _boom, (), results)
    rank, ok, payload = results.get_nowait()
    assert (rank, ok) == (0, False) and "ValueError: boom on rank 0 (cpu)" in pickle.loads(payload)
    assert not dist.is_initialized()


def test_a_failed_rank_ends_the_world_after_the_grace_period(monkeypatch):
    """Once rank 0 has failed, rank 1 (which would wait 600 s) gets the
    grace period, not the world's timeout, and the error names it."""
    monkeypatch.setattr(mesh_lib, "_GRACE_S", 1.0)
    result = mesh_lib.spawn_world(ranks.fail_or_hang, 2, backend="gloo", device="cpu",
                                  timeout_s=300.0)
    assert result.returncode == 1 and result.results == [None, None]
    assert "ValueError: rank 0 fails" in result.errors[0]
    assert result.errors[1] == (
        "no result within the 1 s grace period after rank 0 failed; terminated")


def test_rank_helper_imports_only_the_port():
    """The rank helper, and the port's static checks (which a rank may run
    on the card), import neither JAX nor the JAX package nor a test."""
    analysis = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "analysis"
    paths = [Path(__file__).with_name("torch_dist_ranks.py"), *sorted(analysis.glob("*.py"))]
    assert len(paths) == 8
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "repro", "test_torch_distributed"), f"{path}: {name}"
