"""The port's training slice against the JAX reference on the CPU:
binning, the level-synchronous grower, rotations, packing, MapReduce
training, the pipeline and the train -> serve -> hot-swap loop.

Inputs are made with numpy from a seed (or drawn by the port and handed
over as numpy) and fed to both packages. The packages' random streams
differ, so random draws cross as tensors: the JAX draws of
``rotation_forest._prepare_one`` are recomputed from its key and given to
the port's arithmetic.

Tolerances:
  * bin edges: 1e-6 relative (both interpolate linearly between the same
    order statistics, rounding differently); bin codes exactly equal on
    the reference's edges.
  * grower: ``split_feature`` / ``split_bin`` exactly equal on the same
    codes and bootstrap masks (the histograms are exact integers and the
    split choice runs the same float32 ops in the same order);
    ``leaf_probs`` within 1e-6.
  * rotations: each column equal up to sign within 1e-4 where its
    eigenvalue is separated from its neighbours by more than 1e-3
    relative (eigenvector bases are solver-dependent, and a near-tie
    mixes the two columns).
  * packing exact (gathers); ``predict_proba`` within 1e-6 with the
    argmax equal where the routing margin exceeds 1e-4.
  * global moments within 1e-5 relative (other summation order);
    held-out accuracy >= 0.9 for both packages' forests and within 0.05
    of each other (their random streams differ, so trees cannot be
    compared).
  * whole slice: chunk votes, alarms and lead time exactly equal; window
    votes only where the routing margin is >= 1e-3 z-units (the float32
    denoise/feature differences, the bound of tests/test_torch_engine.py).

Size cuts, each to keep the file's CPU time small: forests of 2-6 trees
of depth 2-4 with 4-8 bins; the grower on 200 rows of 12 features and
the MapReduce fits on 240 rows of 288 (numpy blobs, the EEG slice's
shape, so the reference compiles its sharded fit once); for the EEG
slice 4 training chunks (2 per shard) and a held-out timeline of 0
interictal hours plus the 48-minute run-up (6 chunks, 8 trailing
windows) at full window width, served by one-slot engines at replay
depth 1 (a single session never fills a second slot).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decision_tree as jdt
from repro.core import forest_trainer as jft
from repro.core import mapreduce as jmr
from repro.core import rotation_forest as jrf
from repro.kernels.forest import ops as jforest_ops
from repro.signal import eeg_data as jeeg
from repro.signal import pipeline as jpipeline
from repro_torch import convert
from repro_torch.core import decision_tree as dt
from repro_torch.core import forest_trainer as ft
from repro_torch.core import mapreduce as mr
from repro_torch.core import rotation_forest as rf
from repro_torch.kernels.forest import ops as forest_ops
from repro_torch.serving import api
from repro_torch.signal import eeg_data, features, frontend, pipeline

# One intra-op thread: the suite runs in parallel workers on a shared
# machine, where OpenMP barriers across two threads stall far longer
# than one thread takes to do the work alone.
torch.set_num_threads(1)

PER = 60


def _blobs(seed: int, n: int, f: int = 12, informative: int = 3, shift: float = 1.6):
    """Two Gaussian classes in f dimensions, apart by +-shift in the first
    ``informative`` ones: separable but overlapping."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n).astype(np.int32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[:, :informative] += shift * (2 * y[:, None] - 1)
    return x, y


def _margins(x: np.ndarray, packed) -> np.ndarray:
    """(B,) routing margin: min over trees and live path nodes of
    |x . proj - thr| (how far each row is from flipping a route)."""
    proj, thr = np.asarray(packed.proj), np.asarray(packed.thr)
    depth = proj.shape[-1].bit_length() - 1
    vals = np.einsum("bf,tfl->tbl", x, proj)
    rows = np.arange(x.shape[0])
    out = np.full(x.shape[0], np.inf)
    for t in range(proj.shape[0]):
        node = np.ones(x.shape[0], np.int64)
        for _ in range(depth):
            v, th = vals[t, rows, node], thr[t, node]
            out = np.minimum(out, np.where(np.isfinite(th), np.abs(v - th), np.inf))
            node = 2 * node + (v > th)
    return out


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

def test_bin_edges_and_codes_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(203, 7)).astype(np.float32)
    x[:, 3] = np.round(x[:, 3])  # repeated values: equal edges, codes on an edge
    want = np.asarray(jdt.compute_bin_edges(jnp.asarray(x), 16))
    got = dt.compute_bin_edges(torch.from_numpy(x), 16).numpy()
    assert got.shape == want.shape == (7, 15)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    codes = dt.bin_features(torch.from_numpy(x), torch.from_numpy(want))
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jdt.bin_features(jnp.asarray(x), jnp.asarray(want)))
    )


# ---------------------------------------------------------------------------
# Grower, rotations, packing: one small JAX forest on injected draws
# ---------------------------------------------------------------------------

GROW_CFG = dict(n_trees=3, n_subsets=3, depth=4, n_classes=2, n_bins=8)


def _jax_draws(key, n: int, f: int, cfg) -> rf.TreeDraws:
    """The draws ``jrf._prepare_one(key, ...)`` makes, recomputed from its
    key schedule, as the port's tensors."""
    rot_key, tree_key = jax.random.split(key)
    perm_key, boot_key = jax.random.split(rot_key)
    perm = jax.random.permutation(perm_key, f)
    block = jnp.stack([
        jax.random.uniform(k, (n,)) < cfg.bootstrap_frac
        for k in jax.random.split(boot_key, cfg.n_subsets)
    ])
    tree = jax.random.uniform(tree_key, (n,)) < cfg.bootstrap_frac
    return rf.TreeDraws(
        torch.from_numpy(np.asarray(perm, np.int64)),
        torch.from_numpy(np.asarray(block, np.float32)),
        torch.from_numpy(np.asarray(tree, np.float32)),
    )


@pytest.fixture(scope="module")
def grown():
    """JAX ``_prepare_one`` over 3 tree keys and its fused grower on 200
    blob rows of 12 features; the port's draws are the JAX draws."""
    x, y = _blobs(0, 200)
    jcfg = jrf.RotationForestConfig(**GROW_CFG)
    keys = jax.random.split(jax.random.PRNGKey(3), jcfg.n_trees)
    # One tree per call: the unbatched prep compiles in a third of the
    # vmapped one's time.
    prep = jax.jit(jrf._prepare_one, static_argnames="cfg")
    rots, xbs, ws, edges = (
        jnp.stack(v)
        for v in zip(*(prep(k, jnp.asarray(x), jnp.asarray(y), cfg=jcfg) for k in keys))
    )
    jtrees = jdt.fit_forest_binned(
        xbs, jnp.asarray(y), ws, depth=jcfg.depth, n_classes=2, n_bins=jcfg.n_bins,
        bin_edges=edges,
    )
    per_tree = [_jax_draws(k, x.shape[0], x.shape[1], jcfg) for k in keys]
    draws = rf.TreeDraws(*(torch.stack(v) for v in zip(*per_tree)))
    return dict(
        x=x, y=y, cfg=rf.RotationForestConfig(**GROW_CFG), draws=draws,
        jprep=tuple(np.asarray(v) for v in (rots, xbs, ws, edges)),
        jforest=jrf.RotationForestParams(rotation=rots, trees=jtrees),
    )


def test_grower_splits_equal_jax(grown):
    _, xbs, ws, edges = (torch.from_numpy(v.copy()) for v in grown["jprep"])
    cfg = grown["cfg"]
    got = dt.fit_forest_binned(
        xbs, torch.from_numpy(grown["y"]), ws, depth=cfg.depth, n_classes=2,
        n_bins=cfg.n_bins, bin_edges=edges,
    )
    want = grown["jforest"].trees
    np.testing.assert_array_equal(got.split_feature.numpy(), np.asarray(want.split_feature))
    np.testing.assert_array_equal(got.split_bin.numpy(), np.asarray(want.split_bin))
    np.testing.assert_allclose(got.leaf_probs.numpy(), np.asarray(want.leaf_probs), rtol=0, atol=1e-6)
    assert (got.split_feature.numpy() >= 0).sum() > 10  # the trees did split
    # The per-tree oracle grows the same trees with its own scatter.
    for i in range(cfg.n_trees):
        one = dt.fit_binned(
            xbs[i], torch.from_numpy(grown["y"]), ws[i], depth=cfg.depth, n_classes=2,
            n_bins=cfg.n_bins, bin_edges=edges[i],
        )
        for a, b in zip(one, got):
            assert torch.equal(a, b[i])


def test_grower_int32_codes_equal_jax(grown):
    """Above 256 bins the grower lays its codes out feature-major as int32
    (uint8 below): the same trees as the reference's grower on the
    reference's codes at 300 bins."""
    _, xbs, ws, _ = grown["jprep"]
    y, depth, n_bins = grown["y"], grown["cfg"].depth, 300
    want = jdt.fit_forest_binned(jnp.asarray(xbs), jnp.asarray(y), jnp.asarray(ws),
                                 depth=depth, n_classes=2, n_bins=n_bins)
    got = dt.fit_forest_binned(torch.from_numpy(xbs.copy()), torch.from_numpy(y),
                               torch.from_numpy(ws.copy()), depth=depth, n_classes=2,
                               n_bins=n_bins)
    np.testing.assert_array_equal(got.split_feature.numpy(), np.asarray(want.split_feature))
    np.testing.assert_array_equal(got.split_bin.numpy(), np.asarray(want.split_bin))
    np.testing.assert_allclose(got.leaf_probs.numpy(), np.asarray(want.leaf_probs), rtol=0,
                               atol=1e-6)
    assert (got.split_feature.numpy() >= 0).sum() > 10


def test_fit_equals_per_tree_oracle():
    x, y = _blobs(1, 150)
    cfg = rf.RotationForestConfig(n_trees=3, depth=4, n_bins=8)
    args = (torch.from_numpy(x), torch.from_numpy(y), cfg)
    fused = rf.fit(torch.Generator().manual_seed(5), *args)
    oracle = rf.fit_per_tree(torch.Generator().manual_seed(5), *args)
    assert torch.equal(fused.rotation, oracle.rotation)
    for a, b in zip(fused.trees, oracle.trees):
        assert torch.equal(a, b)
    xt = torch.from_numpy(_blobs(2, 50)[0])
    torch.testing.assert_close(
        rf.predict_proba(fused, xt), rf.predict_proba_per_tree(fused, xt), rtol=0, atol=1e-6
    )


def test_rotation_columns_match_up_to_sign(grown):
    x, cfg, draws = grown["x"], grown["cfg"], grown["draws"]
    rots, xbs, ws, edges = rf._prepare_trees(torch.from_numpy(x), draws, cfg)
    jrots = grown["jprep"][0]
    np.testing.assert_array_equal(ws.numpy(), grown["jprep"][2])
    f = x.shape[1]
    m = f // cfg.n_subsets
    checked = 0
    for t in range(cfg.n_trees):
        perm = draws.perm[t].numpy()
        for i in range(cfg.n_subsets):
            # Block i in permuted space, and its eigenvalues (float64).
            cols = perm[i * m : (i + 1) * m]
            mask = draws.block_masks[t, i].numpy().astype(np.float64)
            xb = x[:, cols].astype(np.float64)
            wsum = max(mask.sum(), 2.0)
            xc = (xb - (xb * mask[:, None]).sum(0) / wsum) * mask[:, None]
            ev = np.sort(np.linalg.eigvalsh(xc.T @ xc / (wsum - 1.0)))[::-1]
            got = rots[t].numpy()[np.ix_(cols, cols)]
            want = jrots[t][np.ix_(cols, cols)]
            for j in range(m):
                gaps = [abs(ev[j] - ev[k]) for k in (j - 1, j + 1) if 0 <= k < m]
                if min(gaps) <= 1e-3 * abs(ev[j]):
                    continue
                sign = np.sign(got[:, j] @ want[:, j])
                assert np.abs(sign * got[:, j] - want[:, j]).max() <= 1e-4
                checked += 1
    assert checked >= 0.9 * cfg.n_trees * f
    # Off-block entries stay exactly zero.
    assert (rots.abs() > 0).sum() == cfg.n_trees * cfg.n_subsets * m * m


def test_pack_and_predict_match_jax(grown):
    jforest = grown["jforest"]
    forest = convert.forest_from_jax(jforest, device="cpu")
    jpacked = jforest_ops.pack_forest(jforest)
    packed = forest_ops.pack_forest(forest)
    for a, b in zip(packed, jpacked):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.isinf(packed.thr.numpy()).any()  # dead nodes are packed too
    xt, _ = _blobs(4, 300)
    want = np.asarray(jrf.predict_proba(jforest, jnp.asarray(xt)))
    got = rf.predict_proba(forest, torch.from_numpy(xt)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    safe = _margins(xt, jpacked) > 1e-4
    assert safe.mean() > 0.9
    np.testing.assert_array_equal(got.argmax(-1)[safe], want.argmax(-1)[safe])
    # And back: the port's arrays rebuild the reference's forest.
    arrays = convert.forest_to_arrays(forest)
    back = jrf.RotationForestParams(
        rotation=jnp.asarray(arrays["rotation"]),
        trees=jdt.TreeParams(*(jnp.asarray(arrays[k]) for k in jdt.TreeParams._fields)),
    )
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jforest)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# MapReduce training
# ---------------------------------------------------------------------------

SLICE_FOREST = dict(n_trees=6, n_subsets=3, depth=3, n_classes=2, n_bins=8)
# The EEG slice's training shape: 4 chunks of 60 windows, F = 288. The
# blob fits below use it too, so the reference compiles its sharded fit
# once for the file.
SLICE_ROWS, SLICE_F = 4 * PER, 288


def _blobs_288(seed: int, n: int):
    return _blobs(seed, n, SLICE_F, informative=12, shift=1.0)


@pytest.fixture(scope="module")
def mapreduce_fits():
    """Both packages' fit_mapreduce(n_shards=2) on the same 240 blob rows
    of 288 features."""
    x, y = _blobs_288(7, SLICE_ROWS)
    jres = jft.fit_mapreduce(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y),
        jrf.RotationForestConfig(**SLICE_FOREST), n_shards=2,
    )
    res = ft.fit_mapreduce(
        torch.Generator().manual_seed(0), torch.from_numpy(x), torch.from_numpy(y),
        rf.RotationForestConfig(**SLICE_FOREST), n_shards=2,
    )
    return x, y, jres, res


def test_global_moments_match_jax(mapreduce_fits):
    _, _, jres, res = mapreduce_fits
    for got, want in ((res.feat_mean, jres.feat_mean), (res.feat_std, jres.feat_std)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_mapreduce_accuracy_matches_jax(mapreduce_fits):
    *_, jres, res = mapreduce_fits
    assert res.forest.rotation.shape[0] == jres.forest.rotation.shape[0] == 6
    xt, yt = _blobs_288(8, 600)
    jacc = float(jrf.accuracy(
        jres.forest, (jnp.asarray(xt) - jres.feat_mean) / jres.feat_std, jnp.asarray(yt)
    ))
    acc = float(rf.accuracy(
        res.forest, (torch.from_numpy(xt) - res.feat_mean) / res.feat_std, torch.from_numpy(yt)
    ))
    assert acc >= 0.9 and jacc >= 0.9
    assert abs(acc - jacc) <= 0.05


@pytest.mark.parametrize("n_trees,n_shards,per_shard,total", [
    (6, 2, None, 6), (5, 2, None, 6), (1, 3, None, 3), (6, 2, 1, 2),
])
def test_union_tree_count(n_trees, n_shards, per_shard, total):
    x, y = _blobs(9, 60 * n_shards)
    cfg = rf.RotationForestConfig(n_trees=n_trees, depth=2, n_bins=4)
    res = ft.fit_mapreduce(
        torch.Generator().manual_seed(1), torch.from_numpy(x), torch.from_numpy(y), cfg,
        n_shards=n_shards, trees_per_shard=per_shard,
    )
    assert ft._shard_trees(n_trees, n_shards) == jft._shard_trees(n_trees, n_shards)
    assert res.forest.rotation.shape[0] == total
    assert all(v.shape[0] == total for v in res.forest.trees)


def test_fit_mapreduce_rejects_mesh_and_ragged_shards():
    x, y = torch.zeros((10, 6)), torch.zeros(10, dtype=torch.int32)
    cfg = rf.RotationForestConfig(n_trees=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ft.fit_mapreduce(torch.Generator(), x, y, cfg, mesh=object())
    with pytest.raises(ValueError, match="shard evenly"):
        ft.fit_mapreduce(torch.Generator(), x, y, cfg, n_shards=3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mr.MapReduce(lambda t: t).run(None, x)


def test_merge_is_associative():
    x, y = _blobs(10, 90)
    cfg = rf.RotationForestConfig(n_trees=2, depth=3, n_bins=8)
    a, b, c = (
        rf.fit(torch.Generator().manual_seed(s), torch.from_numpy(x), torch.from_numpy(y), cfg)
        for s in range(3)
    )
    left, right = rf.merge(rf.merge(a, b), c), rf.merge(a, rf.merge(b, c))
    for u, v in zip(jax.tree.leaves(tuple(left)), jax.tree.leaves(tuple(right))):
        assert torch.equal(u, v)
    assert left.rotation.shape[0] == 6
    assert torch.equal(mr.reduce_concat([a, b, c]).rotation, left.rotation)


def test_run_local_reducers_match_jax():
    x = np.random.default_rng(11).normal(size=(12, 5)).astype(np.float32)
    for jred, red in ((jmr.reduce_sum, mr.reduce_sum), (jmr.reduce_mean, mr.reduce_mean),
                      (jmr.reduce_max, mr.reduce_max), (jmr.reduce_concat, mr.reduce_concat)):
        want = jmr.MapReduce(lambda t: (t**2, jnp.sum(t)), jred).run_local(3, jnp.asarray(x))
        got = mr.MapReduce(lambda t: (t**2, t.sum()), red).run_local(3, torch.from_numpy(x))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# EEG data, alarm rule and lead time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_inter,n_pre,tail", [(7, 3, 0), (2, 2, 13), (1, 6, 0)])
def test_stratify_chunks_order_matches_jax(n_inter, n_pre, tail):
    w = (n_inter + n_pre) * PER + tail
    labels = np.concatenate([np.zeros(n_inter * PER), np.ones(n_pre * PER + tail)]).astype(np.int32)
    ids = np.arange(w, dtype=np.float32)[:, None, None]  # each window carries its index
    want = jeeg.stratify_chunks(jeeg.Recording(jnp.asarray(ids), jnp.asarray(labels)))
    got = eeg_data.stratify_chunks(eeg_data.Recording(torch.from_numpy(ids), torch.from_numpy(labels)))
    np.testing.assert_array_equal(got.windows.numpy(), np.asarray(want.windows))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))


def test_recordings_have_the_reference_layout():
    g = torch.Generator().manual_seed(0)
    rec = eeg_data.make_training_set(g, 3, n_interictal_windows=5, n_preictal_windows=7)
    assert rec.windows.shape == (12, 3, 2048) and rec.labels.tolist() == [0] * 5 + [1] * 7
    tl = eeg_data.make_test_timeline(g, 3, hours_interictal=0, minutes_preictal=8)
    assert tl.windows.shape == (68, 3, 2048) and tl.labels.tolist() == [1] * 68
    assert torch.isfinite(tl.windows).all()


def test_alarm_rule_and_lead_time_match_jax():
    rng = np.random.default_rng(13)
    cfg, jcfg = pipeline.PipelineConfig(), jpipeline.PipelineConfig()
    n = 17
    preds = rng.integers(0, 2, size=n).astype(np.int32)
    alarms = pipeline.alarm_state(torch.from_numpy(preds), cfg).numpy()
    np.testing.assert_array_equal(alarms, np.asarray(jpipeline.alarm_state(jnp.asarray(preds), jcfg)))
    for onset in (-1, 0, n // 2):  # no preictal chunk, all preictal, a run-up
        true = np.zeros(n, np.int32)
        if onset >= 0:
            true[onset:] = 1
        got = float(pipeline.lead_time_from_alarms(alarms, true))
        assert got == float(jpipeline.lead_time_from_alarms(alarms, true))
    wp = rng.integers(0, 2, size=4 * PER + 7).astype(np.int32)
    wp[:PER] = np.arange(PER) % 2  # exactly half: not preictal
    np.testing.assert_array_equal(
        pipeline.chunk_predictions(torch.from_numpy(wp), cfg).numpy(),
        np.asarray(jpipeline.chunk_predictions(jnp.asarray(wp), jcfg)),
    )


# ---------------------------------------------------------------------------
# The whole slice on EEG: a JAX-trained pipeline carried across, and the
# port's own train -> checkpoint -> serve -> hot-swap loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slice_data():
    """A stratified 4-chunk training set and a held-out timeline of the
    48-minute run-up and the seizure (368 windows: 6 chunks and a tail),
    drawn by the port, at full window width."""
    g = torch.Generator().manual_seed(21)
    rec = eeg_data.stratify_chunks(eeg_data.make_training_set(g, 3, 2 * PER, 2 * PER))
    timeline = eeg_data.make_test_timeline(g, 3, hours_interictal=0)
    return rec, timeline


def test_process_windows_scans_the_stream(slice_data):
    """process_windows is frontend_step scanned over whole chunks from a
    zero context (the halo carried at overlap 2). A ragged recording is
    wrap-padded by tiling the WHOLE recording cyclically, as
    ``jnp.resize`` does: the last chunk is filled up with the recording's
    first windows, and the padding rows are cut."""
    _, timeline = slice_data
    cfg = pipeline.PipelineConfig(overlap=2)
    windows = timeline.windows[: 2 * PER + 7]
    got = pipeline.process_windows(windows, cfg)
    state = frontend.init_state(overlap=2, device="cpu")
    want = []
    last = torch.cat([windows[2 * PER :], windows[: PER - 7]])
    for chunk in (windows[:PER], windows[PER : 2 * PER], last):
        state, f = frontend.frontend_step(state, chunk, cfg)
        want.append(f)
    assert got.shape == (2 * PER + 7, 288)
    assert torch.equal(got, torch.cat(want)[: 2 * PER + 7])
    assert int(state.phase) == 3


def test_carried_jax_pipeline_scores_like_jax(slice_data):
    """A JAX-trained pipeline (the reference's MapReduce fit on these
    training features) evaluated by both packages on one timeline."""
    rec, timeline = slice_data
    cfg = pipeline.PipelineConfig(forest=rf.RotationForestConfig(**SLICE_FOREST))
    jcfg = jpipeline.PipelineConfig(forest=jrf.RotationForestConfig(**SLICE_FOREST))
    feats = pipeline.process_windows(rec.windows, cfg).numpy()
    res = jft.fit_mapreduce(
        jax.random.PRNGKey(2), jnp.asarray(feats), jnp.asarray(rec.labels.numpy()),
        jcfg.forest, n_shards=2,
    )
    jfitted = jpipeline.FittedPipeline(res.forest, res.feat_mean, res.feat_std)
    # Whole chunks only on the JAX side: its tail path would compile the
    # reference's process_windows once more (the port's tail is covered below).
    n_whole = timeline.windows.shape[0] // PER * PER
    windows = timeline.windows[:n_whole]
    labels = timeline.labels[:n_whole]
    want = jpipeline.evaluate_timeline(
        jfitted, jeeg.Recording(jnp.asarray(windows.numpy()), jnp.asarray(labels.numpy())), jcfg
    )
    fitted = convert.fitted_from_jax(jfitted, device="cpu")
    got = pipeline.evaluate_timeline(fitted, eeg_data.Recording(windows, labels), cfg)
    np.testing.assert_array_equal(got.chunk_preds.numpy(), np.asarray(want.chunk_preds))
    np.testing.assert_array_equal(got.alarms.numpy(), np.asarray(want.alarms))
    assert float(got.lead_time_minutes) == float(want.lead_time_minutes)
    assert int(got.onset_chunk) == int(want.onset_chunk)
    assert got.alarms.sum() > 0 and float(got.lead_time_minutes) > 0
    bad = np.nonzero(got.window_preds.numpy() != np.asarray(want.window_preds))[0]
    if bad.size:
        normed, _, _ = features.normalize(
            pipeline.process_windows(windows, cfg), fitted.feat_mean, fitted.feat_std
        )
        packed = forest_ops.pack_forest(fitted.forest)
        assert (_margins(normed.numpy(), packed)[bad] < 1e-3).all()
    # The fitted pipeline round-trips through the flat arrays.
    again = convert.fitted_from_arrays(convert.fitted_to_arrays(fitted), device="cpu")
    for a, b in zip(jax.tree.leaves(tuple(again)), jax.tree.leaves(tuple(fitted))):
        assert torch.equal(a, b)


def _serve(engine, patient, windows, lo=0, hi=None, step=37):
    """Push windows[lo:hi] in chunk-unaligned pieces; the scored events."""
    session = engine.session(patient) or engine.open_session(patient)
    hi = windows.shape[0] if hi is None else hi
    events = []
    for i in range(lo, hi, step):
        session.push(windows[i : min(i + step, hi)])
        events += engine.poll()
    return [e for e in events if isinstance(e, api.ChunkScored)]


@pytest.fixture(scope="module")
def port_slice(slice_data, tmp_path_factory):
    """The port's MapReduce fit, checkpointed and reloaded, its
    ``evaluate_timeline`` result, and a retrain on fresh draws."""
    rec, timeline = slice_data
    cfg = pipeline.PipelineConfig(forest=rf.RotationForestConfig(**SLICE_FOREST))
    fitted = pipeline.fit(torch.Generator().manual_seed(1), rec, cfg, n_shards=2)
    directory = str(tmp_path_factory.mktemp("program"))
    api.ScoringProgram.from_fitted(fitted, cfg).save(directory)
    program = api.ScoringProgram.load(directory, device="cpu")
    res = pipeline.evaluate_timeline(fitted, timeline, cfg)
    fitted2 = pipeline.fit(torch.Generator().manual_seed(2), rec, cfg, n_shards=2)
    return cfg, fitted, program, res, fitted2, timeline


def test_port_fit_serves_its_own_oracle(port_slice):
    cfg, fitted, program, res, _, timeline = port_slice
    assert fitted.forest.rotation.shape == (6, 288, 288)
    engine = api.SeizureEngine(program, max_batch=1, replay_depth=1, device="cpu")
    scored = _serve(engine, 3, timeline.windows.numpy())
    assert [e.alarm for e in scored] == res.alarms.tolist()
    assert [e.chunk_pred for e in scored] == res.chunk_preds.tolist()
    n = timeline.windows.shape[0]
    assert res.window_preds.shape == (n,) and res.alarms.sum() > 0
    # The tail windows (no whole chunk) are the pipeline's own predictions.
    tail = n // PER * PER
    np.testing.assert_array_equal(
        res.window_preds[tail:].numpy(),
        pipeline.predict_windows(fitted, timeline.windows[tail:], cfg).numpy(),
    )
    accuracy = float((res.window_preds == timeline.labels).float().mean())
    assert accuracy >= 0.7


def test_swap_program_stamps_versions_and_matches_composite_oracle(port_slice):
    cfg, _, program, res, fitted2, timeline = port_slice
    wins = timeline.windows.numpy()
    n_chunks = wins.shape[0] // PER
    k_swap = n_chunks // 2
    engine = api.SeizureEngine(program, max_batch=1, replay_depth=1, device="cpu")
    scored = _serve(engine, 7, wins, 0, k_swap * PER)
    version = engine.swap_program(api.ScoringProgram.from_fitted(fitted2, cfg))
    assert version == engine.program_version == 1
    scored += _serve(engine, 7, wins, k_swap * PER, n_chunks * PER)
    assert [e.program_version for e in scored] == [0] * k_swap + [1] * (n_chunks - k_swap)
    new = pipeline.evaluate_timeline(fitted2, timeline, cfg).chunk_preds
    combined = torch.cat([res.chunk_preds[:k_swap], new[k_swap:n_chunks]])
    assert [e.alarm for e in scored] == pipeline.alarm_state(combined, cfg).tolist()
    assert engine.swap_program(program, version=7) == 7


def test_swap_program_refuses_drift(port_slice):
    cfg, _, program, *_ = port_slice
    engine = api.SeizureEngine(program, max_batch=1, device="cpu")
    drifted = api.ScoringProgram(program.packed, program.feat_mean, program.feat_std,
                                 cfg._replace(alarm_k=2))
    with pytest.raises(ValueError, match="PipelineConfig"):
        engine.swap_program(drifted)
    smaller = forest_ops.PackedForest(*(v[:3] for v in program.packed))
    with pytest.raises(ValueError, match="proj"):
        engine.swap_program(api.ScoringProgram(smaller, program.feat_mean, program.feat_std, cfg))
    assert engine.program_version == 0 and engine.program.packed.proj.shape[0] == 6


def test_fit_rejects_shards_off_chunk_boundaries(slice_data):
    rec, _ = slice_data
    cfg = pipeline.PipelineConfig(forest=rf.RotationForestConfig(n_trees=2))
    with pytest.raises(ValueError, match="WINDOWS_PER_MATRIX"):
        pipeline.fit(torch.Generator(), rec, cfg, n_shards=3)


def test_train_forest_launcher_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train_forest

    rc = train_forest.main([
        "--device", "cpu", "--trees", "2", "--depth", "3", "--bins", "8",
        "--train-chunks", "2", "--hours-interictal", "0", "--batch", "1",
        "--replay-depth", "1", "--save-dir", str(tmp_path),
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "served alarms == pipeline oracle" in out and "composite oracle" in out
