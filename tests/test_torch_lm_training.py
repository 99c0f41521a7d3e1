"""The port's LM training slice on the CPU, against the JAX package.

Every input is drawn from numpy with a seed; every model's parameters are
the reference's own (``Model.init`` with a ``jax.random`` key), carried
across by ``convert.train_state_from_jax``, and each reference function is
built and jitted once for the file (module-scoped fixtures). Configs:
qwen3-0.6b reduced (2 layers, d_model 256, GQA 4:2, qk-norm, vocab 512)
and zamba2-7b reduced to 3 Mamba2 blocks with a shared attention site
every 2 (one full group, which remat recomputes, and a remainder group).
All float32.

Tolerances:
  * ``rmsnorm``'s dx and dscale against ``jax.vjp`` of the reference's
    custom VJP: float32 1e-5 absolute and relative (the same formulas);
    bfloat16 inputs 2^-7 relative to each output's largest element (one
    bf16 rounding of dx, both packages; dscale is float32).
  * gradients, at each leaf's scale: max|port - jax| <= GRAD_REL max|jax|
    per leaf. 1e-5 for one attention layer (f32 products of length <=
    2048 summed in other orders); 1e-4 for a whole model (two or three
    layers of that, through a 512-way log-softmax; the largest reading,
    1e-5, is Mamba2's ``A_log``, whose gradient sums exp-decay terms over
    the sequence).
  * losses: 1e-5 relative (a mean of float32 log-softmax values).
  * one AdamW update, at the learning rate's scale: the first update is
    lr (g / (|g| + eps) + wd p), so a gradient element within a few eps
    of 0 can move its update by up to lr between packages. Elements whose
    gradient is at least 100 eps hold |port - jax| <= 1e-3 lr; every
    element <= 2 lr + its weight-decay term's rounding.
  * remat on against off in the port: equal bits (the same ops replayed).
  * checkpoints: equal bits.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.configs.base import InputShape as JInputShape
from repro.data import synthetic as jsynthetic
from repro.models import build as jbuild
from repro.models import layers as jly
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.optim import apply_updates as japply_updates
from repro.optim import schedule as jschedule
from repro.training import TrainState as JTrainState
from repro.training import train_state_shapes as jtrain_state_shapes
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.ensemble import ensemble_grads
from repro_torch.data import pipeline, synthetic
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import train as train_launch
from repro_torch.models import build, layers as ly, params as pr
from repro_torch.optim import AdamWConfig, adamw, schedule
from repro_torch.training import trainer
from repro_torch.training import TrainState, make_train_step, train_state_shapes

# One intra-op thread: the suite runs in parallel workers on a shared
# machine (see test_torch_kernels.py).
torch.set_num_threads(1)

LAYER_REL = 1e-5
GRAD_REL = 1e-4
LOSS_TOL = dict(atol=0, rtol=1e-5)
LR = 1e-3
EPS = 1e-8
B, S = 4, 64


def _dense(get):
    return get("qwen3-0.6b").reduced()


def _hybrid(get):
    return dataclasses.replace(get("zamba2-7b").reduced(), n_layers=3, attn_every=2)


class Pair:
    """One reduced config in both packages on the reference's parameters,
    with the reference's loss-and-gradient function jitted once."""

    def __init__(self, make, seed: int):
        self.cfg, self.jcfg = make(get_config), make(jget_config)
        self.jmodel = jbuild(self.jcfg)
        self.jparams = self.jmodel.init(jax.random.PRNGKey(seed))
        self.model = build(self.cfg)
        toks = np.random.default_rng(seed).integers(
            0, self.cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
        self.np_batch = {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()}
        (self.jloss, _), self.jgrads = jax.jit(jax.value_and_grad(
            self.jmodel.loss, has_aux=True))(self.jparams, self.jbatch())
        self._jstep = None

    def jstep(self) -> JTrainState:
        """The reference's first train step from its parameters on the
        batch: the body of its ``make_train_step`` (the optimizer's update,
        AdamW at LR with a cosine warm-up over 1 of 10 steps, then
        ``apply_updates``) on the fixture's jitted gradients. Its own
        jitted train step computes the same function and compiles for
        seconds more; with microbatches it takes the mean of the
        microbatches' gradients, which for equal microbatches of a mean
        loss is this gradient."""
        if self._jstep is None:
            jopt = jadamw(JAdamWConfig(lr=LR), jschedule.cosine_warmup(LR, 1, 10))
            updates, opt = jax.jit(jopt.update)(self.jgrads, jopt.init(self.jparams),
                                                self.jparams)
            self._jstep = JTrainState(japply_updates(self.jparams, updates), opt)
        return self._jstep

    def jbatch(self):
        return {k: jnp.asarray(v) for k, v in self.np_batch.items()}

    def batch(self):
        return {k: torch.from_numpy(v.copy()) for k, v in self.np_batch.items()}

    def params(self):
        return convert.train_state_from_jax(self.jparams, 0, self.jparams, self.jparams,
                                            device="cpu").params


@pytest.fixture(scope="module")
def dense():
    return Pair(_dense, 0)


@pytest.fixture(scope="module")
def hybrid():
    return Pair(_hybrid, 1)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _close_scaled(got, want, rel: float, what: str = "") -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _close_tree(got: dict, want, rel: float) -> None:
    """Port tree against the reference's (nested dicts), leaf by leaf."""
    want = convert.lm_params_from_jax(want)
    flat = {".".join(path): t for path, t in pr.flatten(got)}
    assert set(flat) == set(want)
    for key, t in flat.items():
        _close_scaled(t, want[key], rel, key)


def _jtree_np(tree) -> dict:
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Layers: the rmsnorm VJP and chunked attention under grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_vjp_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.dtype) or t,
                                                  lambda t: t):
        y = ly.rmsnorm({"scale": st}, xt)
    # The residual is x in its own dtype (the reference's _rmsnorm_fwd).
    assert saved == [tdt, torch.float32]
    dx, dscale = torch.autograd.grad(y, (xt, st), torch.from_numpy(g).to(tdt))
    jy, vjp = jax.vjp(lambda xx, ss: jly.rmsnorm({"scale": ss}, xx),
                      jnp.asarray(x, jdt), jnp.asarray(scale))
    jdx, jdscale = vjp(jnp.asarray(g, jdt))
    assert dx.dtype == tdt and dscale.dtype == torch.float32
    if dtype == "float32":
        for got, want in ((y, jy), (dx, jdx), (dscale, jdscale)):
            np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    else:
        for got, want in ((y, jy), (dx, jdx), (dscale, jdscale)):
            _close_scaled(got, want, 2.0**-7)


def test_chunked_attention_grads_match_jax(dense):
    """``attn_apply(chunked=True)`` at S = 2048, batch 1 (two 1024-row query
    chunks, each a checkpoint recomputed in the backward): the input's and
    every attention weight's gradient against ``jax.grad``."""
    cfg, jcfg = dense.cfg, dense.jcfg
    jp = jax.tree.map(lambda t: t[0], dense.jparams["blocks"]["attn"])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 2048, cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)

    def jf(p, xx):
        return jnp.sum(jly.attn_apply(jcfg, p, xx, chunked=True) * ct)

    _, (jgp, jgx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(jp, jnp.asarray(x))
    p = convert.train_state_from_jax(jp, 0, jp, jp, device="cpu").params
    xt = torch.from_numpy(x)
    recomputed = []

    def f(tree):
        return torch.sum(ly.attn_apply(cfg, tree["p"], tree["x"], chunked=True)
                         * torch.from_numpy(ct))

    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: recomputed.append(t.shape) or t, lambda t: t):
        _, grads = trainer.value_and_grad(f)({"p": p, "x": xt})
    # No (1, K, G, 1024, 2048) score tensor is saved: the chunks' scores
    # are recomputed in the backward.
    assert not any(len(sh) == 5 and sh[-1] == 2048 for sh in recomputed)
    _close_tree(grads["p"], jgp, LAYER_REL)
    _close_scaled(grads["x"], jgx, LAYER_REL, "x")


# ---------------------------------------------------------------------------
# The model: loss, gradients, remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_loss_and_grads_match_jax(dense, hybrid, family):
    pair = {"dense": dense, "hybrid": hybrid}[family]
    (loss, metrics), grads = trainer.value_and_grad(pair.model.loss, has_aux=True)(
        pair.params(), pair.batch())
    np.testing.assert_allclose(float(loss), float(pair.jloss), **LOSS_TOL)
    assert float(metrics["aux"]) == 0 and float(metrics["ce"]) == float(loss)
    _close_tree(grads, pair.jgrads, GRAD_REL)
    # ensemble_grads is the same (loss, grads) with no reduction.
    eloss, egrads = ensemble_grads(lambda p, b: pair.model.loss(p, b)[0], pair.params(),
                                   pair.batch(), None)
    assert float(eloss) == float(loss)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(pr.flatten(egrads),
                                                           pr.flatten(grads)))


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_remat_gives_the_same_gradients(dense, hybrid, family):
    """``cfg.remat`` (a checkpoint per dense block, per full hybrid group)
    gives the bits of remat off, and so the reference's gradients too."""
    pair = {"dense": dense, "hybrid": hybrid}[family]
    assert not pair.cfg.remat
    remat = build(dataclasses.replace(pair.cfg, remat=True))
    saved = []
    grads = {}
    for name, model in (("off", pair.model), ("on", remat)):
        count = []
        params = pr.unflatten((p, t.requires_grad_()) for p, t in pr.flatten(pair.params()))
        with torch.autograd.graph.saved_tensors_hooks(lambda t: count.append(1) or t,
                                                      lambda t: t):
            model.apply(params, pair.batch())
        saved.append(len(count))
        grads[name] = trainer.value_and_grad(model.loss, has_aux=True)(
            pair.params(), pair.batch())[1]
    assert saved[1] < saved[0] / 2, saved  # remat saves far fewer activations
    for (_, a), (_, b) in zip(pr.flatten(grads["on"]), pr.flatten(grads["off"])):
        assert torch.equal(a, b)
    _close_tree(grads["on"], pair.jgrads, GRAD_REL)


def test_loss_mask_branch_matches_jax(dense):
    """The masked cross-entropy (max(sum(mask), 1) in the denominator), with
    a mask that keeps some positions and one that keeps none."""
    mask = (np.random.default_rng(5).random((B, S)) < 0.3).astype(np.float32)
    jloss = jax.jit(dense.jmodel.loss)
    for m in (mask, np.zeros_like(mask)):
        batch = dict(dense.batch(), mask=torch.from_numpy(m))
        got, metrics = dense.model.loss(dense.params(), batch)
        want, jmetrics = jloss(dense.jparams, dict(dense.jbatch(), mask=jnp.asarray(m)))
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    assert float(got) == 0.0


def test_param_shapes_and_master_params(dense):
    model = build(dense.cfg)
    jshapes = dense.jmodel.param_shapes()
    flat = {".".join(p): s for p, s in pr.flatten(model.param_shapes())}
    jflat = {".".join(str(k.key) for k in p): s
             for p, s in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert {k: (s.shape, s.dtype) for k, s in flat.items()} == {
        k: (tuple(s.shape), torch.float32) for k, s in jflat.items()}
    model.load_params(dense.params(), device="cpu")  # a nested tree
    masters = model.master_params()
    for (_, a), (_, b) in zip(pr.flatten(masters), pr.flatten(dense.params())):
        assert torch.equal(a, b)
    next(iter(masters["blocks"]["ffn"].values())).add_(1.0)  # a copy
    assert torch.equal(model.master_params()["blocks"]["ffn"]["wo"],
                       dense.params()["blocks"]["ffn"]["wo"])
    # The shapes of the state match the reference's train_state_shapes.
    ts = train_state_shapes(model, adamw(AdamWConfig()))
    jts = jtrain_state_shapes(dense.jmodel, jadamw(JAdamWConfig()))
    assert ts.opt.step.shape == tuple(jts.opt.step.shape) and ts.opt.step.dtype == torch.int32
    assert ([s.shape for _, s in pr.flatten(ts.opt.v)]
            == [tuple(s.shape) for s in jax.tree.leaves(jts.opt.v)])


# ---------------------------------------------------------------------------
# Optimizer and the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, args", [("constant", (1e-3,)),
                                        ("linear_warmup", (1e-3, 3, 10, 1e-4)),
                                        ("cosine_warmup", (1e-3, 3, 10))])
def test_schedules_match_jax(name, args):
    steps = np.arange(0, 13, dtype=np.int32)
    got = [float(getattr(schedule, name)(*args)(torch.tensor(s))) for s in steps]
    want = [float(getattr(jschedule, name)(*args)(jnp.asarray(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _check_update(got_params, want_params, before, want_m):
    """The update each package applied, at the learning rate's scale (see
    the module docstring); the clipped gradient is the reference's m / (1 -
    b1) after a first step."""
    want = convert.lm_params_from_jax(want_params)
    p0 = {".".join(p): t for p, t in pr.flatten(before)}
    g = {k: t / (1 - AdamWConfig.b1) for k, t in convert.lm_params_from_jax(want_m).items()}
    for path, t in pr.flatten(got_params):
        key = ".".join(path)
        du, jdu = t - p0[key], want[key] - p0[key]
        diff = (du - jdu).abs()
        big = g[key].abs() >= 100 * EPS
        assert float(torch.where(big, diff, 0.0).max()) <= 1e-3 * LR, key
        assert float(diff.max()) <= 2.01 * LR, key


def _opt():
    return adamw(AdamWConfig(lr=LR), schedule.cosine_warmup(LR, 1, 10))


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_jax(dense, microbatches):
    jnew = dense.jstep()
    opt = _opt()
    params = dense.params()
    before = trainer.clone_tree(params)
    state = TrainState(params, opt.init(params))
    new, metrics = make_train_step(dense.model, opt, microbatches)(state, dense.batch())
    assert new.params is params and new.opt.m is state.opt.m  # written in place
    np.testing.assert_allclose(float(metrics["loss"]), float(dense.jloss), **LOSS_TOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(dense.jloss), **LOSS_TOL)
    assert float(metrics["aux"]) == 0
    assert int(new.opt.step) == int(jnew.opt.step) == 1
    # m = (1 - b1) clip(g): the clipped, microbatch-averaged gradient.
    _close_tree(new.opt.m, jnew.opt.m, GRAD_REL)
    _check_update(new.params, jnew.params, before, jnew.opt.m)


def test_hybrid_train_step_matches_jax(hybrid):
    jnew = hybrid.jstep()
    opt = _opt()
    params = hybrid.params()
    before = trainer.clone_tree(params)
    new, metrics = make_train_step(hybrid.model, opt)(TrainState(params, opt.init(params)),
                                                      hybrid.batch())
    np.testing.assert_allclose(float(metrics["loss"]), float(hybrid.jloss), **LOSS_TOL)
    _close_tree(new.opt.v, jnew.opt.v, 2 * GRAD_REL)  # (1 - b2) g^2: twice g's error
    _check_update(new.params, jnew.params, before, jnew.opt.m)


def test_ensemble_members_train_apart(dense):
    """Two members from generators of their own: each steps on its own
    half of the batch exactly as a single model would, with no gradient
    shared, and the members diverge."""
    model = dense.model
    opt = adamw(AdamWConfig(lr=LR))
    gen = torch.Generator().manual_seed(7)
    states = trainer.ensemble_init(model, opt, gen, 2, device="cpu")
    assert states.opt.step.shape == (2,)
    singles = [trainer.clone_tree(trainer.member(states, m)) for m in range(2)]
    assert not torch.equal(singles[0].params["embed"], singles[1].params["embed"])
    batch = dense.batch()
    step = trainer.make_ensemble_train_step(model, opt, None, 2)
    out, metrics = step(states, batch)
    assert out is states and metrics["loss"].shape == (2,)
    one = make_train_step(model, opt)
    for m in range(2):
        _, single_metrics = one(singles[m], {k: v[2 * m:2 * m + 2] for k, v in batch.items()})
        assert float(metrics["loss"][m]) == float(single_metrics["loss"])
        for (_, a), (_, b) in zip(pr.flatten(trainer.member(out.params, m)),
                                  pr.flatten(singles[m].params)):
            assert torch.equal(a, b)
    assert states.opt.step.tolist() == [1, 1]
    # The member axis rides 'data' (the ensemble over two ranks steps its
    # members in tests/torch_dist_ranks.py): the member specs equal the
    # reference's on the qwen3 parameter specs of the production mesh.
    from jax.sharding import PartitionSpec as P

    from conftest import abstract_mesh
    from repro.sharding import rules as jrules
    from repro.training import trainer as jtrainer
    from repro_torch.sharding import rules

    jcfg = jget_config("qwen3-0.6b")
    jspecs = jrules.param_pspecs(jcfg, abstract_mesh((16, 16), ("data", "model")),
                                 jbuild(jcfg).param_shapes())
    want = jax.tree_util.tree_flatten_with_path(
        jtrainer.ensemble_member_pspecs(jspecs), is_leaf=lambda x: isinstance(x, P))[0]
    cfg = get_config("qwen3-0.6b")
    got = dict(pr.flatten(trainer.ensemble_member_pspecs(rules.param_pspecs(
        cfg, {"data": 16, "model": 16}, build(cfg).param_shapes()))))
    assert len(got) == len(want)
    for path, spec in want:
        assert got[tuple(p.key for p in path)] == tuple(spec)
    with pytest.raises(ValueError, match="other than 'data'"):
        trainer.make_ensemble_train_step(model, opt, type("M", (), {
            "mesh_dim_names": ("data", "model"), "shape": (1, 2)})(), 2)


# ---------------------------------------------------------------------------
# Data, checkpoints, the launcher, the gates
# ---------------------------------------------------------------------------

def test_batches_follow_the_reference():
    cfg, jcfg = get_config("qwen3-0.6b"), jget_config("qwen3-0.6b")
    for kind in ("train", "prefill", "decode"):
        got = synthetic.batch_specs(cfg, InputShape("t", 64, 3, kind))
        want = jsynthetic.batch_specs(jcfg, JInputShape("t", 64, 3, kind))
        assert {k: (s.shape, s.dtype) for k, s in got.items()} == {
            k: (tuple(s.shape), torch.int32) for k, s in want.items()}
    stream = pipeline.BatchStream(cfg, InputShape("t", 256, 4, "train"), seed=3, device="cpu")
    first = next(iter(stream))
    state = stream.state_dict()
    b = stream.batch_at(0)
    assert state == {"seed": 3, "step": 1}
    assert all(torch.equal(first[k], b[k]) for k in b)
    assert not torch.equal(stream.batch_at(1)["tokens"], b["tokens"])
    toks, tgt = b["tokens"], b["targets"]
    assert toks.dtype == torch.int32 and toks.shape == (4, 256)
    assert torch.equal(tgt[:, :-1], toks[:, 1:])  # one (b, s + 1) draw, shifted
    # every odd position is (31 x previous + 7) mod V; the rest Zipf-heavy
    assert torch.equal(toks[:, 1::2], (toks[:, 0:-1:2] * 31 + 7) % cfg.vocab_size)
    assert float((toks[:, ::2] < 100).float().mean()) > 0.3
    stream.load_state_dict({"seed": 3, "step": 0})
    assert torch.equal(next(iter(stream))["tokens"], b["tokens"])
    # The audio and vlm batches (held to the reference's specs in
    # tests/test_torch_families.py): frames with targets and a mask; patches
    # counted in the sequence before the text.
    hub = synthetic.make_batch(get_config("hubert-xlarge"), InputShape("t", 8, 1, "train"),
                               torch.Generator())
    assert sorted(hub) == ["frames", "mask", "targets"] and hub["frames"].shape == (1, 8, 512)
    pali = synthetic.make_batch(get_config("paligemma-3b"), InputShape("t", 264, 1, "train"),
                                torch.Generator())
    assert pali["patches"].shape == (1, 256, 2048) and pali["tokens"].shape == (1, 8)
    # Placed by batch_pspecs on a (1, 1) mesh (a fake world of one rank):
    # DTensors holding the same batch (the two-rank stream is in
    # tests/torch_dist_ranks.py).
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.sharding import rules

    mesh = make_fake_mesh((1, 1), ("data", "model"))
    try:
        specs = rules.batch_pspecs(cfg, mesh, b)
        placed = pipeline.BatchStream(cfg, InputShape("t", 256, 4, "train"), seed=3,
                                      shardings=(mesh, specs), device="cpu").batch_at(0)
        assert all(placed[k].placements == tuple(rules.named(mesh, specs[k])) for k in b)
        assert all(torch.equal(placed[k].full_tensor(), b[k]) for k in b)
    finally:
        dist.destroy_process_group()


def test_train_checkpoint_crosses_packages(dense, tmp_path):
    """A JAX train checkpoint restores in the port, and the port's in JAX,
    bit for bit, after one step of each (m and v nonzero)."""
    jstate = dense.jstep()
    jckpt.save(str(tmp_path / "jax"), 1, jstate)
    model, opt = dense.model, _opt()
    got = trainer.restore_state(str(tmp_path / "jax"), 1, like=train_state_shapes(model, opt),
                                device="cpu")
    want = convert.train_state_from_jax(*_jtree_np((jstate.params, jstate.opt.step,
                                                    jstate.opt.m, jstate.opt.v)), device="cpu")
    for (pa, a), (pb, b) in zip(pr.flatten(got._asdict() | {"opt": got.opt._asdict()}),
                                pr.flatten(want._asdict() | {"opt": want.opt._asdict()})):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa

    # The port's state after a step of its own, into JAX.
    state, _ = make_train_step(model, opt)(got, dense.batch())
    trainer.save_state(str(tmp_path / "port"), 2, state)
    back = jckpt.restore(str(tmp_path / "port"), 2, like=jstate)
    params, step, m, v = convert.train_state_to_jax(state)
    assert int(back.opt.step) == int(step) == 2
    for want_tree, got_tree in ((params, back.params), (m, back.opt.m), (v, back.opt.v)):
        for a, b in zip(jax.tree.leaves(want_tree), jax.tree.leaves(got_tree)):
            np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="does not match"):
        trainer.restore_state(str(tmp_path / "port"), 2, like=train_state_shapes(
            build(dataclasses.replace(dense.cfg, d_ff=128)), opt), device="cpu")


def test_launch_train_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    args = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "2", "--batch", "4",
            "--seq", "32", "--microbatches", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    train_launch.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step    0 loss=" in out and "[train] step    1 loss=" in out
    assert "tokens/s" in out and "[train] done" in out
    cfg = get_config("qwen3-0.6b").reduced()
    state = trainer.restore_state(str(tmp_path), 2, like=train_state_shapes(
        build(cfg), adamw(AdamWConfig())), device="cpu")
    assert int(state.opt.step) == 2
    train_launch.main(["--arch", "zamba2-7b", "--reduced", "--steps", "1", "--batch", "2",
                       "--seq", "16", "--ensemble", "2", "--device", "cpu"])
    assert "loss=[" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launch.main(args)


def test_kernels_refuse_grad_and_gates_shut(monkeypatch):
    """K5 and K6 have no backward: their gates are shut to activations
    that require grad, and a CUDA input that requires grad raises in their
    routers (routed as CUDA here by patching the device test)."""
    cfg = get_config("qwen3-0.6b")
    cuda = type("T", (), {"device": torch.device("cuda"), "requires_grad": False})()
    grad = type("T", (), {"device": torch.device("cuda"), "requires_grad": True})()
    assert ly._use_flash_kernel(cfg, 2048, 0, cuda)
    assert not ly._use_flash_kernel(cfg, 2048, 0, grad)
    q = torch.zeros(1, 512, 2, 128, requires_grad=True)
    k = torch.zeros(1, 512, 1, 128)
    launched = []
    monkeypatch.setattr(flash_ops, "on_cuda", lambda *a: True)
    monkeypatch.setattr(flash_ops._kernel, "flash_attention",
                        lambda *a, **kw: launched.append(1))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_ops.flash_attention(q, k, k)
    with torch.no_grad():
        flash_ops.flash_attention(q, k, k)
    flash_ops.flash_attention(q.detach(), k, k)
    assert len(launched) == 2
    monkeypatch.setattr(ssd_ops, "on_cuda", lambda *a: True)
    c = torch.zeros(1, 64, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_ops.ssd_scan_grouped(c, c, torch.zeros(1, 64, 2, 32, requires_grad=True),
                                 torch.zeros(1, 64, 2), chunk=32)
