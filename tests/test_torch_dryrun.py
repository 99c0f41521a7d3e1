"""The port's dry-run tools: ``launch.cost_analysis`` on steps of known
analytic cost (as ``tests/test_hlo_analysis.py`` holds the reference's
HLO analyzer), per-device counts on a fake world, a reduced forward's
matmul flops against the JAX analyzer's, and ``launch.dryrun``'s
``input_specs``, ``model_flops`` and ``auto_microbatches`` against the
JAX package's.

A fake world (``backend="fake"``) is process-global: every test that
makes one destroys it on the way out (``_fake_world``), so later tests in
the same worker see no world.

Tolerances: flops and collective bytes exactly (both are counts of
shapes); a reduced dense or xLSTM forward's matmul flops within 2% of the
JAX analyzer's (measured: equal, 0.0%); HBM bytes of an n-step loop
within [1.6, 2.4] x of the n/2-step loop's (the reference's bound); a
scan's counts equal to the loop's it stands for.
"""

from __future__ import annotations

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from conftest import abstract_mesh
from repro.configs import INPUT_SHAPES as JSHAPES, get_config as jget_config
from repro.launch import hlo_analysis
from repro.models import build as jbuild
from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.models import build, params as pr, scan_core


@contextlib.contextmanager
def _fake_world(shape=(1, 1), names=("data", "model")):
    """A fake world of prod(shape) ranks and its mesh, destroyed on exit."""
    assert not dist.is_initialized()
    try:
        yield make_fake_mesh(shape, names)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jdryrun():
    """The JAX package's dryrun module. It sets XLA_FLAGS to 512 host
    devices at import, which only takes effect before jax's backend starts:
    start it first, and put the variable back after."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jd


# ---------------------------------------------------------------------------
# cost_analysis on known costs
# ---------------------------------------------------------------------------

def _cost(fn, *args):
    with FakeTensorMode():
        fake = [torch.empty(a) if isinstance(a, tuple) else a for a in args]
        with ca.CostMode(exclude=fake) as mode:
            fn(*fake)
    return mode


def test_plain_and_batched_matmul_flops():
    a, b, k = 32, 48, 64
    assert _cost(lambda x, y: x @ y, (a, k), (k, b)).flops == 2 * a * b * k
    got = _cost(lambda x, y: torch.einsum("bik,bkj->bij", x, y), (4, 8, 16), (4, 16, 8))
    assert got.flops == 4 * 2 * 8 * 8 * 16


def test_a_loop_counts_every_trip():
    """The reference weights a scan body by its trip count; an eager loop
    runs (and is counted) n times, nested loops n_outer x n_inner."""
    n, m = 8, 64

    def loop(x, ws):
        for i in range(ws.shape[0]):
            x = x @ ws[i]
        return x

    assert _cost(loop, (m, m), (n, m, m)).flops == n * 2 * m ** 3

    def nested(x, ws):
        for g in range(ws.shape[0]):
            for i in range(ws.shape[1]):
                x = x @ ws[g, i]
        return x

    assert _cost(nested, (32, 32), (3, 5, 32, 32)).flops == 3 * 5 * 2 * 32 ** 3


def _scan_body(h, xs):
    (w,) = xs
    h = torch.tanh(h @ w)
    return h, h * 2.0


def test_scan_counts_one_body_times_its_trips():
    """``scan_core.scan`` under a CostMode runs its body once and counts it
    ``trips`` times: forward flops and HBM bytes equal the eager loop's
    (whose stack the scan's one output write matches), and the backward's
    matmul flops too, counted as the autograd engine runs the one trip's
    nodes. The outputs keep their shapes."""
    n, m = 8, 32
    calls = []

    def body(h, xs):
        calls.append(1)
        return _scan_body(h, xs)

    def loop(h, ws):
        ys = []
        for t in range(ws.shape[0]):
            h, y = _scan_body(h, [ws[t]])
            ys.append(y)
        return h, torch.stack(ys)

    counts = {}
    for name, fn in (("loop", loop), ("scan", lambda h, ws: scan_core.scan(body, h, [ws]))):
        with FakeTensorMode():
            h0, ws = torch.empty(m, m, requires_grad=True), torch.empty(n, m, m, requires_grad=True)
            with ca.CostMode(exclude=(h0, ws)) as mode:
                h, ys = fn(h0, ws)
                forward = (mode.flops, mode.hbm_bytes)
                (h.sum() + ys.sum()).backward()
        assert tuple(h.shape) == (m, m) and tuple(ys.shape) == (n, m, m)
        counts[name] = forward, mode.flops
    assert len(calls) == 1
    assert counts["scan"][0] == counts["loop"][0] == (n * 2 * m ** 3, counts["loop"][0][1])
    assert counts["scan"][1] == counts["loop"][1] == 3 * n * 2 * m ** 3


def test_eager_scan_gives_the_loop_bits():
    """Outside a CostMode ``scan`` is the loop it replaced in
    ``xlstm.slstm_apply``, bit for bit: a reduced sLSTM block's output and
    final state against that loop, kept here."""
    from repro_torch.models import xlstm
    from repro_torch.models.layers import rmsnorm

    cfg = get_config("xlstm-1.3b").reduced()
    model = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    _, p = model.compute_params()[1][0]       # super-block 0: (mLSTM blocks, sLSTM block)
    u = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(1))
    got, cache = xlstm.slstm_apply(cfg, p, u, return_cache=True)
    b, s, d = u.shape
    wx = xlstm._slstm_inputs(cfg, p, rmsnorm(p["ln"], u))
    c = n = hn = torch.zeros((b, cfg.n_heads, d // cfg.n_heads), dtype=torch.float32)
    hs = []
    for t in range(s):
        c, n, hn = xlstm._slstm_step(cfg, p, [w[:, t] for w in wx], c, n, hn)
        hs.append(hn.to(u.dtype))
    want = xlstm._slstm_out(p, u, torch.stack(hs, dim=1))
    assert torch.equal(got, want)
    for key, t in (("c", c), ("n", n), ("h", hn)):
        assert torch.equal(cache[key], t)


def test_hbm_bytes_scale_with_trip_count():
    m = 128

    def loop(x, ws):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x

    b5 = _cost(loop, (m, m), (5, m, m)).hbm_bytes
    b10 = _cost(loop, (m, m), (10, m, m)).hbm_bytes
    assert 1.6 < b10 / b5 < 2.4
    # one step: mm reads two (m, m) f32 operands and writes one, tanh one in
    # and one out; the select of ws[i] is a view and moves nothing
    assert _cost(loop, (m, m), (1, m, m)).hbm_bytes == 5 * m * m * 4


def test_roofline_bottleneck_labels():
    peak, bw, link = 989e12, 3.35e12, 50e9
    t = ca.roofline_terms(ca.StepCost(989e12, 1, 1, {}), peak_flops=peak, hbm_bw=bw,
                          ici_bw=link)
    assert t["bottleneck"] == "compute" and t["compute_s"] == 1.0
    t = ca.roofline_terms(ca.StepCost(1, 3.35e12 * 2, 1, {}), peak_flops=peak, hbm_bw=bw,
                          ici_bw=link)
    assert t["bottleneck"] == "memory" and t["memory_s"] == 2.0
    t = ca.roofline_terms(ca.StepCost(1, 1, 50e9 * 3, {"all-reduce": 50e9 * 3}),
                          peak_flops=peak, hbm_bw=bw, ici_bw=link)
    assert t["bottleneck"] == "collective" and t["collective_s"] == 3.0


def test_row_parallel_matmul_counts_the_local_shard():
    """x (16, 256) split on its columns and w (256, 128) on its rows over 4
    fake ranks: each rank multiplies (16, 64) @ (64, 128), 1/4 of the
    global flops, and the partial sums' all-reduce moves twice the local
    (16, 128) float32 output. (FlopCounterMode on the DTensor op itself
    would count the global product.) DTensor's propagation of the product's
    global shape went through the method CostMode leaves uncounted: were it
    to stop doing so, its global-shape ops would be counted with no error."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with _fake_world((4,), ("model",)) as mesh, FakeTensorMode():
        x = distribute_tensor(torch.empty(16, 256), mesh, [Shard(1)], src_data_rank=None)
        w = distribute_tensor(torch.empty(256, 128), mesh, [Shard(0)], src_data_rank=None)
        with ca.CostMode(exclude=(x, w)) as mode:
            y = (x @ w).redistribute(mesh, [Replicate()])
        assert tuple(y.shape) == (16, 128)
    assert mode.propagations > 0
    assert mode.flops == 2 * 16 * 256 * 128 / 4
    assert mode.coll_by_type == {"all-reduce": 2 * 16 * 128 * 4}


def _forward_flops(arch: str, s: int) -> tuple[float, float]:
    """A reduced forward of (2, s) tokens: the reference's
    ``hlo_analysis.analyze`` flops of the compiled forward, and the port's
    on a (1, 1) mesh of a fake world."""
    jcfg = jget_config(arch).reduced()
    jmodel = jbuild(jcfg)
    toks = jax.ShapeDtypeStruct((2, s), jnp.int32)
    compiled = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t})).lower(
        jmodel.param_shapes(), toks).compile()
    want = hlo_analysis.analyze(compiled.as_text()).flops
    cfg = get_config(arch).reduced()
    with _fake_world() as mesh, FakeTensorMode():
        model = build(cfg, act_axes=("data",), mesh=mesh)
        model.load_params(model.distribute_params(pr.shape_tree(model.param_specs(), "cpu")),
                          device="cpu")
        cost, _ = dryrun.trace(lambda b: model.forward(b),
                               ({"tokens": torch.zeros(2, s, dtype=torch.int32)},))
    return cost.flops, want


def test_forward_matmul_flops_match_the_jax_analyzer():
    """A reduced qwen3 forward on a (1, 1) mesh against the reference's
    ``hlo_analysis.analyze`` of the same forward, compiled: dot flops
    within 2% (the two count the same projections, attention einsums and
    unembedding)."""
    got, want = _forward_flops("qwen3-0.6b", 64)
    assert got == pytest.approx(want, rel=0.02)


def test_xlstm_forward_matmul_flops_match_the_jax_analyzer():
    """The same for a reduced xlstm-1.3b forward (an mLSTM and an sLSTM
    block) at S = 512: the reference counts its sLSTM ``lax.scan`` body once
    and weights it by the known trip count, the port's ``scan`` runs one
    trip that the cost mode weights alike (measured: equal). S = 512 makes
    two mLSTM chunks of 256: at one chunk XLA folds the inter-chunk product
    with the zero initial state away, which the port counts."""
    got, want = _forward_flops("xlstm-1.3b", 512)
    assert got == pytest.approx(want, rel=0.02)


# ---------------------------------------------------------------------------
# dryrun against the JAX package's
# ---------------------------------------------------------------------------

def _shapes_and_dtypes(tree):
    return [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in jax.tree.leaves(tree)]


def _port_shapes_and_dtypes(tree):
    leaves = [t for t in torch.utils._pytree.tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]
    return [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in leaves]


@pytest.mark.parametrize("arch,shape_name", [("qwen3-0.6b", "train_4k"),
                                             ("xlstm-1.3b", "decode_32k"),
                                             ("paligemma-3b", "prefill_32k")])
def test_input_specs_match_jax(jdryrun, arch, shape_name):
    """Every input of the step, leaf by leaf in the reference's order:
    global shapes and dtypes equal the JAX ``input_specs``' on a (1, 1)
    mesh (its ShapeDtypeStructs against the port's fake DTensors)."""
    from repro.launch.mesh import make_host_mesh

    _, jargs = jdryrun.input_specs(arch, shape_name, make_host_mesh(1, 1))
    with _fake_world() as mesh, FakeTensorMode():
        _, args = dryrun.input_specs(arch, shape_name, mesh)
        got = _port_shapes_and_dtypes(args)
    want = _shapes_and_dtypes(jargs)
    assert len(got) == len(want)
    # the reference's state leaves are ordered (params, step, m, v), the
    # port's AdamWState likewise; within each, sorted paths in both
    assert got == want


def test_model_flops_and_microbatches_match_jax(jdryrun):
    meshes = [({"data": 16, "model": 16}, abstract_mesh((16, 16), ("data", "model"))),
              ({"pod": 2, "data": 16, "model": 16},
               abstract_mesh((2, 16, 16), ("pod", "data", "model")))]
    for arch in ARCH_NAMES:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for name, shape in INPUT_SHAPES.items():
            jshape = JSHAPES[name]
            assert dryrun.model_flops(cfg, shape, shape.kind) == jdryrun.model_flops(
                jcfg, jshape, jshape.kind)
            for mesh, jmesh in meshes:
                assert dryrun.auto_microbatches(cfg, shape, mesh) == \
                    jdryrun.auto_microbatches(jcfg, jshape, jmesh)


def test_dryrun_on_a_2x2_fake_world_completes():
    """One decode step of qwen3-0.6b at its widths, cut to one layer, on a
    2x2 fake mesh: a record with no error, per-device memory and costs,
    and the collectives the 2d strategy needs there (FSDP gathers, tensor-
    parallel all-reduces). (Train steps are traced on the production
    meshes by the dry run itself, about a minute each.)"""
    with _fake_world((2, 2)) as mesh:
        rec = dryrun.run_one("qwen3-0.6b", "decode_32k", cfg_overrides={"n_layers": 1},
                             mesh=mesh, verbose=False)
    assert "error" not in rec and rec["n_devices"] == 4 and rec["mesh"] == "2x2"
    assert rec["arg_bytes"] > 0 and rec["temp_bytes"] > 0 and rec["fits_hbm"]
    assert set(rec["coll_by_type"]) >= {"all-gather", "all-reduce"}
    assert rec["hlo_flops_per_dev"] > 0 and rec["bottleneck"] in ("compute", "memory",
                                                                  "collective")
    assert np.isfinite(rec["useful_flops_ratio"])
