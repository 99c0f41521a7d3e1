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
shapes); a reduced dense forward's matmul flops within 2% of the JAX
analyzer's (measured: equal, 0.0%); HBM bytes of an n-step loop within
[1.6, 2.4] x of the n/2-step loop's (the reference's bound).
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
from repro_torch.models import build, params as pr


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


def test_forward_matmul_flops_match_the_jax_analyzer():
    """A reduced qwen3 forward on a (1, 1) mesh against the reference's
    ``hlo_analysis.analyze`` of the same forward, compiled: dot flops
    within 2% (the two count the same projections, attention einsums and
    unembedding)."""
    jcfg = jget_config("qwen3-0.6b").reduced()
    jmodel = jbuild(jcfg)
    toks = jax.ShapeDtypeStruct((2, 64), jnp.int32)
    compiled = jax.jit(lambda p, t: jmodel.forward(p, {"tokens": t})).lower(
        jmodel.param_shapes(), toks).compile()
    want = hlo_analysis.analyze(compiled.as_text()).flops
    cfg = get_config("qwen3-0.6b").reduced()
    with _fake_world() as mesh, FakeTensorMode():
        model = build(cfg, act_axes=("data",), mesh=mesh)
        model.load_params(model.distribute_params(pr.shape_tree(model.param_specs(), "cpu")),
                          device="cpu")
        cost, _ = dryrun.trace(lambda b: model.forward(b),
                               ({"tokens": torch.zeros(2, 64, dtype=torch.int32)},))
    assert cost.flops == pytest.approx(want, rel=0.02)


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
