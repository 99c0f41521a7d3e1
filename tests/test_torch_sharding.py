"""The port's sharding rules (``repro_torch.sharding.rules``) against the
JAX package's, leaf for leaf: parameter specs for every arch, both
production meshes and every strategy; batch, cache and logits specs for
every applicable arch x shape. The rules need only axis names and sizes:
the JAX side runs on ``conftest.abstract_mesh``, the port's on a mapping
of the same names and sizes (no process group).

Also: ``params.shape_tree`` allocates nothing and equals the reference's
shapes, and ``named`` turns a spec into DTensor placements.
"""

from __future__ import annotations

import functools

import jax
import pytest
from jax.sharding import PartitionSpec as P

from conftest import abstract_mesh
from repro.configs import get_config as jget_config
from repro.data.synthetic import batch_specs as jbatch_specs
from repro.models import build as jbuild, for_shape as jfor_shape
from repro.sharding import rules as jrules
from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config, shape_applicable
from repro_torch.data.synthetic import batch_specs
from repro_torch.models import build, for_shape
from repro_torch.models import params as pr
from repro_torch.sharding import rules

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STRATEGIES = ("2d", "fsdp", "dp", "dp_vocab")


def _meshes(name):
    sizes, names = MESHES[name]
    return abstract_mesh(sizes, names), dict(zip(names, sizes))


@functools.cache
def _shapes(arch: str, shape_name: str | None = None):
    """(JAX param shapes, port param shapes), once per arch (and shape)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    if shape_name is not None:
        jcfg, cfg = jfor_shape(jcfg, shape_name), for_shape(cfg, shape_name)
    return jcfg, cfg, jbuild(jcfg), build(cfg)


def _flat_jax(tree):
    """(path tuple, leaf) of a JAX tree of dicts, sorted as ``pr.flatten``."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        out.append((tuple(p.key for p in path), leaf))
    return sorted(out, key=lambda kv: kv[0])


def _assert_same(jtree, tree):
    want = _flat_jax(jtree)
    got = pr.flatten(tree)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, w), (_, g) in zip(want, got):
        assert tuple(w) == g, (path, tuple(w), g)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_pspecs_equal_jax(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    jcfg, cfg, jmodel, model = _shapes(arch)
    jshapes, shapes = jmodel.param_shapes(), model.param_shapes()
    for strategy in STRATEGIES:
        for align in (True, False):
            _assert_same(jrules.param_pspecs(jcfg, jmesh, jshapes, strategy, align_heads=align),
                         rules.param_pspecs(cfg, mesh, shapes, strategy, align_heads=align))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_cache_and_logits_pspecs_equal_jax(arch):
    n = 0
    for mesh_name in MESHES:
        jmesh, mesh = _meshes(mesh_name)
        for shape_name, shape in INPUT_SHAPES.items():
            jcfg, cfg, jmodel, model = _shapes(arch, shape_name)
            if not shape_applicable(cfg, shape)[0]:
                continue
            n += 1
            for strategy in STRATEGIES:
                _assert_same(
                    jrules.batch_pspecs(jcfg, jmesh, jbatch_specs(jcfg, shape), strategy),
                    rules.batch_pspecs(cfg, mesh, batch_specs(cfg, shape), strategy))
                assert (tuple(jrules.logits_pspec(jcfg, jmesh, shape.global_batch, strategy))
                        == rules.logits_pspec(cfg, mesh, shape.global_batch, strategy))
                if shape.kind == "decode" and not cfg.is_encoder:
                    b, s = shape.global_batch, shape.seq_len
                    _assert_same(
                        jrules.cache_pspecs(jcfg, jmesh, jmodel.cache_shapes(b, s), b, strategy),
                        rules.cache_pspecs(cfg, mesh, model.cache_shapes(b, s), b, strategy))
    assert n > 0


def test_shape_tree_allocates_nothing_and_matches_jax():
    jcfg, cfg, jmodel, model = _shapes("qwen3-moe-30b-a3b")
    shapes = model.param_shapes()
    want = _flat_jax(jmodel.param_shapes())
    got = pr.flatten(shapes)
    assert [(p, tuple(s.shape)) for p, s in want] == [(p, tuple(t.shape)) for p, t in got]
    assert all(t.device.type == "meta" and t.dtype.is_floating_point for _, t in got)
    assert sum(t.numel() for _, t in got) == model.param_count() == jmodel.param_count()


def test_named_placements():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert rules.named(Mesh, (("pod", "data"), None, "model")) == [Shard(0), Shard(0), Shard(2)]
    assert rules.named(Mesh, ()) == [Replicate()] * 3
    assert rules.named(Mesh, (None, "data")) == [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="mesh order"):
        rules.named(Mesh, (("data", "pod"),))
    with pytest.raises(ValueError, match="used twice"):
        rules.named(Mesh, ("data", "data"))
