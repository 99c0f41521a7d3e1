"""The port's kernel packages (K1 forest, K2 wpd_level with its one-launch
packet tree and DWT, K3 gram, K4 histogram) on the CPU.

Each plain PyTorch version is held to the JAX package's ``ref.py`` on the
same numpy-seeded inputs; the CUDA kernels themselves run only on the
card (``chip_smoke.py`` holds each against its plain version there). The
routing rule is pinned too: a CPU tensor takes the plain version, and a
kernel wrapper refuses a CPU tensor without counting a launch. Last, the
port must import neither ``jax`` nor ``repro``.

Tolerances:
  * wpd_level and gram: max abs <= 1e-5 * max|ref| and relative Frobenius
    <= 1e-5 -- both sides sum the same float32 products in a different
    order (taps, or the length-n contraction), a few ulps apart.
  * wpd_tree and dwt_levels: the chained plain levels, held like one level
    (each level's sums a few ulps from JAX's, carried into the next).
  * forest: the leaf one-hots are exact, and the sums over trees are
    taken in the same ascending order, so the summed probabilities agree
    to 1e-6 and the argmax is equal wherever the routing margin
    ``min |x . proj - thr|`` along the path exceeds 1e-4 (a float32
    matmul of length F can move a split value by ~1e-6 of its scale).
  * histogram: exactly equal on 0/1 class masses (every sum is an integer
    below 2**24, so the scatter and the reference's one-hot slab matmuls
    agree whatever their order); within 1e-6 relative on float masses
    (other summation order).
"""

from __future__ import annotations

import ast
import importlib.util
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.forest import ref as jforest_ref
from repro.kernels.gram import ref as jgram_ref
from repro.kernels.histogram import kernel as jhist_kernel
from repro.kernels.histogram import ops as jhist_ops
from repro.kernels.histogram import ref as jhist_ref
from repro.kernels.wpd import kernel as jwpd_kernel
from repro.kernels.wpd import ref as jwpd_ref
from repro.signal import wavelet as jwavelet
from repro_torch.kernels.forest import kernel as forest_kernel
from repro_torch.kernels.forest import ops as forest_ops
from repro_torch.kernels.forest import ref as forest_ref
from repro_torch.kernels.gram import kernel as gram_kernel
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.histogram import kernel as hist_kernel
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.kernels.wpd import kernel as wpd_kernel
from repro_torch.kernels.wpd import ops as wpd_ops
from repro_torch.serving import api
from repro_torch.signal import wavelet

# One intra-op thread: the suite runs in parallel workers on a shared
# machine, where OpenMP barriers across two threads stall far longer
# than one thread takes to do the work alone.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _close(got: np.ndarray, want: np.ndarray, rel: float) -> None:
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale
    assert np.linalg.norm(got - want) <= rel * np.linalg.norm(want)


# ---------------------------------------------------------------------------
# K1 forest
# ---------------------------------------------------------------------------

def _packed(rng, n_trees, f, depth, n_classes=2, dead_frac=0.2):
    n_leaves = 2**depth
    proj = rng.normal(size=(n_trees, f, n_leaves)).astype(np.float32)
    thr = rng.normal(scale=2.0, size=(n_trees, n_leaves)).astype(np.float32)
    thr[rng.random(thr.shape) < dead_frac] = np.inf
    leaf = rng.random((n_trees, n_leaves, n_classes)).astype(np.float32)
    leaf /= leaf.sum(-1, keepdims=True)
    return proj, thr, leaf


def _margins(x, proj, thr):
    """(B,) JAX-side routing margin: min over trees and path nodes of
    |x . proj - thr| (dead nodes never decide a route)."""
    depth = proj.shape[-1].bit_length() - 1
    vals = np.asarray(jnp.einsum("bf,tfl->tbl", x, proj))
    out = np.full(x.shape[0], np.inf)
    for t in range(proj.shape[0]):
        node = np.ones(x.shape[0], np.int64)
        for _ in range(depth):
            v = vals[t, np.arange(x.shape[0]), node]
            gap = np.abs(v - thr[t, node])
            out = np.minimum(out, np.where(np.isfinite(thr[t, node]), gap, np.inf))
            node = 2 * node + (v > thr[t, node])
    return out


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_forest_plain_matches_jax_ref(depth):
    rng = np.random.default_rng(37 + depth)
    b, f, n_trees = 37, 16, 3
    proj, thr, leaf = _packed(rng, n_trees, f, depth)
    x = rng.normal(size=(b, f)).astype(np.float32)
    want = np.asarray(jforest_ref.forest_traverse(
        jnp.asarray(x), jnp.asarray(proj), jnp.asarray(thr), jnp.asarray(leaf)
    ))
    got = forest_ref.forest_traverse(*map(torch.from_numpy, (x, proj, thr, leaf))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    safe = _margins(x, proj, thr) > 1e-4
    assert safe.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[safe], want.argmax(-1)[safe])


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 6])
def test_leaf_match_matches_jax(depth):
    rng = np.random.default_rng(depth)
    dirs = rng.random((23, 2**depth)) < 0.5
    want = np.asarray(jforest_ref.leaf_match(jnp.asarray(dirs)))
    got = forest_ref.leaf_match(torch.from_numpy(dirs)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == 1).all()


def test_forest_predict_proba_pads_features_and_averages():
    """Features narrower than the forest are right-padded with zeros and
    the sum over trees is divided by T, as the reference does."""
    from repro.kernels.forest import ops as jforest_ops

    rng = np.random.default_rng(5)
    proj, thr, leaf = _packed(rng, 4, 12, 3)
    x = rng.normal(size=(19, 10)).astype(np.float32)
    jpacked = jforest_ops.PackedForest(*map(jnp.asarray, (proj, thr, leaf)))
    want = np.asarray(jforest_ops.forest_predict_proba(
        jpacked, jnp.asarray(x), use_pallas=False
    ))
    packed = forest_ops.PackedForest(*map(torch.from_numpy, (proj, thr, leaf)))
    got = forest_ops.forest_predict_proba(packed, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


def _walk_emulated(x, proj, thr, leaf):
    """K1's walk over its derived tables, in float32 on the host: each row
    starts at its tree's first live node and follows next_node until a
    leaf, computing one column's dot product per step. Returns the summed
    leaf rows (ascending tree order) and the steps taken per (row, tree)."""
    proj_nodes = forest_kernel.node_major(torch.from_numpy(proj)).numpy()
    nxt = forest_kernel.next_live(torch.from_numpy(thr)).numpy()
    n_trees, n_leaves = thr.shape
    rows = np.arange(x.shape[0])
    total = np.zeros((x.shape[0], leaf.shape[-1]), np.float32)
    steps = np.zeros((x.shape[0], n_trees), np.int64)
    for t in range(n_trees):
        node = np.full(x.shape[0], nxt[t, 0, 0])
        while (node < n_leaves).any():
            walking = node < n_leaves
            at = np.minimum(node, n_leaves - 1)
            v = np.einsum("bf,bf->b", x, proj_nodes[t, at])
            nxt_at = nxt[t, at, (v > thr[t, at]).astype(np.int64)]
            node = np.where(walking, nxt_at, node)
            steps[:, t] += walking
        total += leaf[t, node - n_leaves]
    return total, steps


@pytest.mark.parametrize("depth", [6])
def test_forest_walk_tables_match_jax_ref(depth):
    """K1's layout: the node-major proj and the next-live-node table, walked
    as the kernel walks them, give the JAX reference's sums, on forests whose
    dead nodes (40%) also sit above live ones; each walk computes exactly
    the live nodes on its heap path."""
    rng = np.random.default_rng(60 + depth)
    proj, thr, leaf = _packed(rng, 5, 16, depth, dead_frac=0.4)
    x = rng.normal(size=(41, 16)).astype(np.float32)
    want = np.asarray(jforest_ref.forest_traverse(*map(jnp.asarray, (x, proj, thr, leaf))))
    got, steps = _walk_emulated(x, proj, thr, leaf)
    safe = _margins(x, proj, thr) > 1e-4
    assert safe.mean() > 0.5
    np.testing.assert_allclose(got[safe], want[safe], rtol=0, atol=1e-6)
    vals = np.einsum("bf,tfl->tbl", x, proj)
    for t in range(proj.shape[0]):  # live nodes on each row's heap path
        node = np.ones(x.shape[0], np.int64)
        live = np.zeros(x.shape[0], np.int64)
        for _ in range(depth):
            live += np.isfinite(thr[t, node])
            node = 2 * node + (vals[t, np.arange(x.shape[0]), node] > thr[t, node])
        np.testing.assert_array_equal(steps[safe, t], live[safe])


def test_program_derives_walk_tables_and_saves_none(tmp_path):
    """The tables K1 walks are derived where a program is loaded or moved,
    and the checkpoint keeps the reference's leaves only."""
    program = api.ScoringProgram.load(
        str(ROOT / "src" / "repro_torch" / "assets" / "seizure_program"), device="cpu")
    for p in (program, program.to("cpu")):
        packed = p.packed
        assert torch.equal(packed.proj_nodes, packed.proj.transpose(1, 2))
        assert packed.next_node.dtype == torch.int32
        assert packed.next_node.shape == packed.thr.shape + (2,)
    assert set(program._to_arrays()) == {"proj", "thr", "leaf_probs", "feat_mean",
                                         "feat_std", "cfg_json"}
    program.save(str(tmp_path))
    reloaded = api.ScoringProgram.load(str(tmp_path), device="cpu")
    assert torch.equal(reloaded.packed.next_node, program.packed.next_node)


# ---------------------------------------------------------------------------
# K2 wpd_level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["db1", "db2", "db3", "db4"])
def test_wpd_level_plain_matches_jax_ref(name):
    rng = np.random.default_rng(64)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    jh, jg = jwavelet.filters(name)
    want_a, want_d = (np.asarray(v) for v in jwpd_ref.wpd_level(jnp.asarray(x), jh, jg))
    h, g = wavelet.filters(name)
    got_a, got_d = (v.numpy() for v in wpd_ops.wpd_level(torch.from_numpy(x), h, g))
    _close(got_a, want_a, 1e-5)
    _close(got_d, want_d, 1e-5)


def test_wpd_level_short_rows_wrap_fully():
    """Rows shorter than the filter wrap around more than once."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    jh, jg = jwavelet.filters("db4")
    want_a, want_d = (np.asarray(v) for v in jwpd_ref.wpd_level(jnp.asarray(x), jh, jg))
    got_a, got_d = (v.numpy() for v in wpd_ops.wpd_level(torch.from_numpy(x), *wavelet.filters("db4")))
    _close(got_a, want_a, 1e-5)
    _close(got_d, want_d, 1e-5)


@pytest.mark.parametrize("shape, level", [((7, 32), 4), ((2, 3, 64), 5)])
def test_wpd_tree_and_dwt_levels_plain_match_jax(shape, level):
    """The one-launch entries' plain versions against JAX's wpd and dwt;
    rows of 32 end shorter than the filter (WPD nodes of 2, A4 of 2)."""
    rng = np.random.default_rng(level)
    x = rng.normal(size=shape).astype(np.float32)
    h, g = wavelet.filters("db4")
    jtree, jcoeffs = jax.jit(lambda v: (jwavelet.wpd(v, level), jwavelet.dwt(v, level)))(
        jnp.asarray(x))
    tree = wpd_ops.wpd_tree(torch.from_numpy(x), h, g, level)
    assert tree.shape == shape[:-1] + (2**level, shape[-1] >> level)
    _close(tree.numpy(), np.asarray(jtree), 1e-5)
    coeffs = wpd_ops.dwt_levels(torch.from_numpy(x), h, g, level)
    assert len(coeffs) == len(jcoeffs) == level + 1
    for c, jc in zip(coeffs, jcoeffs):
        _close(c.numpy(), np.asarray(jc), 1e-5)


def test_wpd_tree_matches_pallas_interpret():
    """The plain packet tree against the TPU kernel itself, chained level by
    level in interpret mode as JAX's wpd(use_kernel=True) chains it."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    jh, jg = jwavelet.filters("db4")
    nodes = jnp.asarray(x)[:, None, :]
    for _ in range(2):
        a, d = jwpd_kernel.wpd_level(nodes.reshape(-1, nodes.shape[-1]), jh, jg, taps=8,
                                     block_b=8, interpret=True)
        lead = nodes.shape[:-1] + (-1,)
        nodes = jnp.stack([a.reshape(lead), d.reshape(lead)], axis=-2).reshape(3, -1, a.shape[-1])
    got = wpd_ops.wpd_tree(torch.from_numpy(x), *wavelet.filters("db4"), 2)
    _close(got.numpy(), np.asarray(nodes), 1e-5)


@pytest.mark.parametrize("rows, n, level", [(5760, 2048, 5), (7, 32, 4), (180, 2048, 1),
                                            (3, 12288, 4)])
def test_dwt_offsets_lay_scales_apart_and_aligned(rows, n, level):
    """dwt_levels' one output: each scale 256-byte aligned and clear of the
    next, and a scale written one place later still inside the allocation
    (so tools/scoring_faults.py's misplaced detail stays in bounds)."""
    off = wpd_kernel.dwt_offsets(rows, n, level)
    sizes = [rows * (n >> min(j, level)) for j in range(1, level + 2)]
    assert len(off) == level + 2 and off[0] == 0
    for j, size in enumerate(sizes):
        assert off[j] % wpd_kernel.ALIGN == 0
        assert off[j] + size <= off[j + 1]
    for j in range(level):
        assert off[j + 1] + sizes[j] <= off[-1]


# ---------------------------------------------------------------------------
# K3 gram
# ---------------------------------------------------------------------------

def test_gram_plain_matches_jax_ref():
    rng = np.random.default_rng(33)
    x = rng.normal(size=(33, 10)).astype(np.float32)
    want = np.asarray(jgram_ref.gram(jnp.asarray(x)))
    got = gram_ops.gram(torch.from_numpy(x)).numpy()
    _close(got, want, 1e-5)


def test_gram_batched_and_transposed_view():
    """A batch of (n, p) blocks, and the (p, n) variable-major layout read
    through a transposed view (the way pca.fit_T hands it over)."""
    rng = np.random.default_rng(34)
    xt = rng.normal(size=(4, 10, 33)).astype(np.float32)  # (batch, p, n)
    want = np.stack([np.asarray(jgram_ref.gram(jnp.asarray(m.T))) for m in xt])
    view = torch.from_numpy(xt).transpose(-1, -2)
    assert not view.is_contiguous()
    got = gram_ops.gram(view).numpy()
    _close(got, want, 1e-5)


def _gram_emulated(x: np.ndarray, n_split: int, chunk: int) -> np.ndarray:
    """K3's schedule in float32 on the host: the upper 64 x 64 tiles only,
    each split's partial summed in ascending sample order, the partials
    summed in split order from zero, each tile written with its mirror."""
    n, p = x.shape
    tile = gram_kernel.TILE
    tiles = -(-p // tile)
    xp = np.zeros((n, tiles * tile), np.float32)
    xp[:, :p] = x
    out = np.full((tiles * tile, tiles * tile), np.nan, np.float32)
    for ti in range(tiles):
        for tj in range(ti, tiles):
            a, b = xp[:, ti * tile:(ti + 1) * tile], xp[:, tj * tile:(tj + 1) * tile]
            total = np.zeros((tile, tile), np.float32)
            for s in range(n_split):
                acc = np.zeros((tile, tile), np.float32)
                for k in range(s * chunk, min(n, (s + 1) * chunk)):
                    acc += np.outer(a[k], b[k])
                total += acc
            out[ti * tile:(ti + 1) * tile, tj * tile:(tj + 1) * tile] = total
            out[tj * tile:(tj + 1) * tile, ti * tile:(ti + 1) * tile] = total.T
    return out[:p, :p]


@pytest.mark.parametrize("p, n", [(180, 1024), (186, 1024), (180, 64), (186, 64)])
def test_gram_split_schedule_matches_jax_ref(p, n):
    """The kernel's split-and-fixed-order summation, emulated in float32
    at the plans split_plan gives a fit (batch 1) and an engine step
    (batch 32) on 132 SMs, and at the finest split (one slab each)."""
    rng = np.random.default_rng(p + n)
    x = rng.normal(size=(n, p)).astype(np.float32)
    want = np.asarray(jgram_ref.gram(jnp.asarray(x)))
    slab = gram_kernel.SLAB
    plans = {gram_kernel.split_plan(batch, n, p, 132) for batch in (1, 32)}
    plans.add((-(-n // slab), slab))
    assert max(s for s, _ in plans) > 1
    for n_split, chunk in sorted(plans):
        assert chunk % slab == 0 and (n_split - 1) * chunk < n <= n_split * chunk
        got = _gram_emulated(x, n_split, chunk)
        assert not np.isnan(got).any()
        _close(got, want, 1e-5)


def test_gram_split_plan_and_load_mode():
    """The splits chip_smoke.py's shapes get on 132 SMs, and how each
    layout is staged: pca.fit_T's transposed view in 16-byte copies along
    the samples, a contiguous block along the variables, odd strides in
    4-byte copies."""
    plan = gram_kernel.split_plan
    assert plan(32, 1024, 180, 132) == (2, 512)   # an engine step's finest scale
    assert plan(1, 1024, 180, 132) == (32, 32)    # a fit's: 6 tiles, one slab per block
    assert plan(32, 64, 186, 132) == (1, 64)      # the coarsest scale with a halo
    assert plan(1, 256, 180, 132) == (8, 32)
    assert plan(1, 128, 180, 132) == (1, 128)     # under 8 slabs: one launch
    assert plan(1, 64, 186, 132) == (1, 64)
    assert gram_kernel.upper_tiles(180) == 6 and gram_kernel.upper_tiles(186) == 6
    mode = gram_kernel.load_mode
    assert mode(torch.zeros(32, 180, 1024).transpose(1, 2)) == 0
    assert mode(torch.zeros(32, 1024, 180)) == 1
    assert mode(torch.zeros(3, 200, 97)[:, ::2, 1:]) == 2


# ---------------------------------------------------------------------------
# K4 histogram
# ---------------------------------------------------------------------------

def _hist_inputs(seed, t, n, f, n_buckets, c, masses):
    """Codes in [-2, n_buckets + 2): some below 0 and some >= n_buckets,
    which match no bucket. ``masses`` "01" gives one-hot class masses
    under a 0/1 bootstrap mask, as the grower's; "float" random weights."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-2, n_buckets + 2, size=(t, n, f)).astype(np.int32)
    if masses == "01":
        y = rng.integers(0, c, size=n)
        w = (rng.random((t, n)) < 0.75).astype(np.float32)
        wy = w[..., None] * np.eye(c, dtype=np.float32)[y]
    else:
        wy = rng.random((t, n, c)).astype(np.float32)
    return codes, wy


@pytest.mark.parametrize("masses", ["01", "float"])
@pytest.mark.parametrize("t,n,f,n_buckets", [(3, 300, 5, 40), (1, 17, 4, 33)])
def test_class_histogram_plain_matches_jax(t, n, f, n_buckets, masses):
    """N = 300 is ragged against the reference's block_n = 256."""
    codes, wy = _hist_inputs(n + f, t, n, f, n_buckets, 2, masses)
    jc, jw = jnp.asarray(codes), jnp.asarray(wy)
    want_ref = np.asarray(jhist_ref.class_histogram(jc, jw, n_buckets))
    want_kernel = np.asarray(jhist_kernel.class_histogram(
        jc, jw, n_buckets=n_buckets, interpret=True
    ))
    got = hist_ops.class_histogram(torch.from_numpy(codes), torch.from_numpy(wy), n_buckets)
    assert got.shape == (t, f, n_buckets, 2) and got.dtype == torch.float32
    got = got.numpy()
    if masses == "01":
        np.testing.assert_array_equal(got, want_ref)
        np.testing.assert_array_equal(got, want_kernel)
    else:
        _close(got, want_ref, 1e-6)
        _close(got, want_kernel, 1e-6)


def _level_inputs(seed, t, n, f, nodes_at, n_bins, n_classes, masses):
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, n_bins, size=(t, n, f)).astype(np.int32)
    local = rng.integers(0, nodes_at, size=(t, n)).astype(np.int32)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    if masses == "01":
        w = (rng.random((t, n)) < 0.75).astype(np.float32)
    else:
        w = rng.random((t, n)).astype(np.float32)
    return xb, local, y, w


def _level_pair(xb, local, y, w, **kw):
    """(port, JAX): the port's level_histogram on the feature-major codes
    and the reference's ``level_histogram(use_pallas=False)`` on (T, N, F)."""
    want = np.asarray(jhist_ops.level_histogram(
        *map(jnp.asarray, (xb, local, y, w)), use_pallas=False, **kw))
    codes = hist_ops.feature_major(torch.from_numpy(xb), kw["n_bins"])
    got = hist_ops.level_histogram(codes, *map(torch.from_numpy, (local, y, w)), **kw)
    return got, want


def test_level_histogram_matches_jax():
    """The grower's level: bucket = local * n_bins + bin and mass
    w * onehot(y), on a 0/1 bootstrap mask (exact)."""
    kw = dict(nodes_at=4, n_bins=8, n_classes=3)
    got, want = _level_pair(*_level_inputs(12, 3, 300, 6, masses="01", **kw), **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("masses", ["01", "float"])
@pytest.mark.parametrize("n_bins,n,dtype", [(32, 300, torch.uint8), (300, 517, torch.int32)])
def test_level_histogram_feature_major_matches_jax(n_bins, n, dtype, masses):
    """The plain fused level on feature-major codes of the narrowest type
    (uint8 up to 256 bins, int32 above), N ragged against 256: exact on 0/1
    masses, within 1e-6 relative on float weights."""
    kw = dict(nodes_at=4, n_bins=n_bins, n_classes=2)
    inputs = _level_inputs(n_bins + n, 2, n, 5, masses=masses, **kw)
    assert hist_ops.feature_major(torch.from_numpy(inputs[0]), n_bins).dtype == dtype
    got, want = _level_pair(*inputs, **kw)
    assert got.shape == (2, 5, 4 * n_bins, 2) and got.dtype == torch.float32
    if masses == "01":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close(got.numpy(), want, 1e-6)


# ---------------------------------------------------------------------------
# Routing: CPU tensors take the plain version; kernels refuse them
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_cpu_tensors_without_counting():
    x = torch.zeros(4, 16)
    kernels = (forest_kernel, wpd_kernel, gram_kernel, hist_kernel)
    counts = tuple(k.LAUNCHES for k in kernels)
    with pytest.raises(ValueError):
        wpd_kernel.wpd_level(x, *wavelet.filters("db4"))
    with pytest.raises(ValueError):
        wpd_kernel.wpd_tree(x, *wavelet.filters("db4"), 2)
    with pytest.raises(ValueError):
        wpd_kernel.dwt_levels(x, *wavelet.filters("db4"), 2)
    with pytest.raises(ValueError):
        gram_kernel.gram(x[None])
    with pytest.raises(ValueError):
        forest_kernel.forest_traverse(
            x, torch.zeros(1, 4, 16), torch.zeros(1, 4), torch.zeros(1, 4, 2, dtype=torch.int32),
            torch.zeros(1, 4, 2),
        )
    # A packed forest without its walk tables runs the plain version on the CPU.
    proj, thr, leaf = torch.zeros(1, 16, 4), torch.zeros(1, 4), torch.zeros(1, 4, 2)
    assert forest_ops.forest_predict_proba(forest_ops.PackedForest(proj, thr, leaf),
                                           x).shape == (4, 2)
    codes = torch.zeros((1, 4, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        hist_kernel.class_histogram(codes, torch.zeros(1, 4, 2), 8)
    # K4's level mode: feature-major codes (1, 16, 4), uint8 or int32 only.
    level = dict(nodes_at=1, n_bins=8, n_classes=2)
    grower = (torch.zeros((1, 4), dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
              torch.ones(1, 4))
    for dtype in (torch.uint8, torch.int32, torch.int16, torch.int64):
        with pytest.raises(ValueError):
            hist_kernel.level_histogram(torch.zeros((1, 16, 4), dtype=dtype), *grower, **level)
    assert tuple(k.LAUNCHES for k in kernels) == counts
    # The ops route the same CPU tensors to the plain versions.
    assert gram_ops.gram(x).shape == (16, 16)
    assert hist_ops.class_histogram(codes, torch.ones(1, 4, 2), 8).shape == (1, 16, 8, 2)
    assert hist_ops.level_histogram(torch.zeros((1, 16, 4), dtype=torch.uint8), *grower,
                                    **level).shape == (1, 16, 8, 2)
    assert wpd_ops.wpd_level(x, *wavelet.filters("db4"))[0].shape == (4, 8)
    assert wpd_ops.wpd_tree(x, *wavelet.filters("db4"), 2).shape == (4, 4, 4)
    assert [c.shape for c in wpd_ops.dwt_levels(x, *wavelet.filters("db4"), 2)] == [
        (4, 8), (4, 4), (4, 4)]


def test_kernel_library_is_keyed_by_the_sources():
    from repro_torch.kernels import build

    path = build.library_path()
    assert path.parent == ROOT / "build" / "repro_torch"
    assert path == build.library_path()
    assert {p.name for p in build._sources()} >= {"forest.cu", "gram.cu", "histogram.cu", "wpd_level.cu",
                                                  "flash_attention.cu", "ssd_chunks.cu"}


def test_scoring_faults_edit_the_kernel_sources():
    # tools/scoring_faults.py plants each K1 and K2 fault by a text edit of
    # the kernel's source; every edit must find its text there exactly once.
    spec = importlib.util.spec_from_file_location("scoring_faults",
                                                  ROOT / "tools" / "scoring_faults.py")
    faults = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(faults)
    assert set(faults.FAULTS["wpd_level.cu"]) >= {
        "none", "wrap_off_by_one", "paley_swapped", "stale_buffer", "detail_misplaced"}
    assert set(faults.FAULTS["forest.cu"]) >= {
        "none", "last_tree_dropped", "path_short", "lane_dropped"}
    for source, table in faults.FAULTS.items():
        text = (ROOT / "src" / "repro_torch" / "csrc" / source).read_text()
        for name, (_, edits) in table.items():
            assert bool(edits) == (name != "none")
            for old, new in edits:
                assert text.count(old) == 1, (source, name)
                assert new != old


def test_histogram_faults_edit_the_kernel_source():
    # tools/histogram_faults.py plants each K4 fault, and builds each other
    # design it times, by text edits of the kernel's source; every edit must
    # find its text there exactly once.
    spec = importlib.util.spec_from_file_location("histogram_faults",
                                                  ROOT / "tools" / "histogram_faults.py")
    faults = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(faults)
    assert set(faults.FAULTS) >= {"none", "node_off_by_one", "copy_left_out",
                                  "no_merge_barrier", "stride_tail_dropped", "group_stride"}
    assert set(faults.ALTERNATIVES) >= {"match_any"}
    text = (ROOT / "src" / "repro_torch" / "csrc" / faults.SOURCE).read_text()
    for name, (_, edits) in {**faults.FAULTS, **faults.ALTERNATIVES}.items():
        assert bool(edits) == (name != "none")
        for old, new in edits:
            assert text.count(old) == 1, name
            assert new != old


# ---------------------------------------------------------------------------
# The port imports no JAX and nothing of the JAX package
# ---------------------------------------------------------------------------

# Tools that hold the port against the JAX package on the CPU, as the tests
# do: not part of the port, never run on the card.
CPU_REFERENCE_TOOLS = ("gate_reference.py",)


def _port_files():
    assert all((ROOT / "tools" / name).is_file() for name in CPU_REFERENCE_TOOLS)
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted(p for p in (ROOT / "tools").glob("*.py")
                     if p.name not in CPU_REFERENCE_TOOLS))


def test_no_repro_imports_in_port_sources():
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("repro", "jax", "jaxlib"), f"{path}: imports {name}"


def test_every_port_module_imports_without_jax():
    modules = [
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    ]
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.')) for k in sys.modules"
        " if sys.modules[k] is not None)\n"
        f"print('ok', {len(modules)})\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
