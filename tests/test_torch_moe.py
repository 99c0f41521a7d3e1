"""The port's MoE family on the CPU, against the JAX package.

Every input is drawn from numpy with a seed; the model's parameters are
drawn once by the port and handed to the reference as arrays
(``tests/torch_family_pairs.py``); the reference model is built once for
the file (a module fixture) and each of its functions jitted once.
Config: qwen3-moe-30b-a3b reduced (2 layers, d_model 256, 4 experts,
top-2, capacity factor 1.25, qk-norm, GQA 4:1), float32.

Tolerances (``tests/torch_family_pairs.py``):
  * dispatch indices (``buf_tc``, ``buf_valid``, ``slot``, ``kept``) and
    the router's top-k choices on exact ties: exactly equal -- integer
    bookkeeping, and the order that decides which choices are dropped.
  * ``moe_apply`` y: 1e-5 absolute and relative (f32 einsums of length
    <= 256 on O(1) values, summed in another order); aux 1e-5 relative.
  * the model: logits and caches 1e-4 (MODEL_TOL), gradients 1e-4 of each
    leaf's scale (GRAD_REL), losses 1e-5 relative; generated tokens equal.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.serving.continuous import ContinuousEngine as JContinuousEngine
from repro.serving.continuous import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.models import moe
from repro_torch.models import params as pr
from repro_torch.serving.continuous import ContinuousEngine, Request
from repro_torch.serving.engine import ServeEngine
from torch_family_pairs import (
    Pair,
    check_forward,
    check_loss_and_grads,
    check_prefill_decode,
    close,
    jflat_shapes,
)

# One intra-op thread: the suite runs in parallel workers on a shared
# machine (see test_torch_kernels.py).
torch.set_num_threads(1)

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "qwen3-moe-30b-a3b"


@pytest.fixture(scope="module")
def pair():
    return Pair(ARCH, 0)


# ---------------------------------------------------------------------------
# Routing and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [3, 16], ids=["drops", "no-drops"])
def test_dispatch_indices_equal_jax(cap):
    """16 tokens x top-2 over 4 experts: at capacity 3 most experts
    overflow, at 16 none does. The port's batched form against the
    reference on each group."""
    rng = np.random.default_rng(cap)
    idx = rng.integers(0, 4, size=(3, 16, 2)).astype(np.int32)
    got = moe._dispatch_indices(torch.from_numpy(idx), 4, cap)
    kept = got[3].numpy()
    assert (not kept.all()) if cap == 3 else kept.all()
    for g in range(idx.shape[0]):
        want = jmoe._dispatch_indices(jnp.asarray(idx[g]), 4, cap)
        for name, a, b in zip(("buf_tc", "buf_valid", "slot", "kept"), got, want):
            np.testing.assert_array_equal(a[g].numpy(), np.asarray(b), err_msg=name)


def test_top_k_breaks_ties_as_jax():
    """Exact ties go to the lower expert index, as ``jax.lax.top_k``
    orders them (``torch.topk`` gives [2, 4] on the first row); then rows of
    128 experts whose probabilities take 8 distinct values, so every top-8
    crosses ties."""
    rng = np.random.default_rng(0)
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.05]], np.float32)
    _, idx = moe.top_k(torch.from_numpy(probs), 2)
    assert idx.tolist() == [[1, 2]]
    many = rng.integers(0, 8, size=(4, 16, 128)).astype(np.float32) / 8
    for p, k in ((probs, 2), (many, 8)):
        w, idx = moe.top_k(torch.from_numpy(p), k)
        jw, jidx = jax.lax.top_k(jnp.asarray(p), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_moe_apply_matches_jax(pair):
    """One layer's MoE at capacity factor 1.0 (C = 10 for 20 tokens x
    top-2 over 4 experts), so that some choices drop: y and aux."""
    cfg = dataclasses.replace(pair.cfg, capacity_factor=1.0)
    jcfg = dataclasses.replace(pair.jcfg, capacity_factor=1.0)
    jp = jax.tree.map(lambda t: t[0], pair.jparams["blocks"]["moe"])
    p = pair.model.compute_params()[1][0]["moe"]
    x = np.random.default_rng(1).normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    _, _, idx = moe.route(cfg, p, torch.from_numpy(x))
    kept = moe._dispatch_indices(idx, cfg.n_experts, moe.capacity(cfg, 20))[3]
    assert moe.capacity(cfg, 20) == jmoe.capacity(jcfg, 20) == 10
    assert not bool(kept.all())
    y, aux = moe.moe_apply(cfg, p, torch.from_numpy(x))
    jy, jaux = jax.jit(lambda pp, xx: jmoe.moe_apply(jcfg, pp, xx))(jp, jnp.asarray(x))
    close(y, jy, LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_param_tree_mirrors_jax(pair):
    """The parameter tree is the reference's path for path (its
    ``param_shapes``), and ``convert.lm_params_from_jax`` carries the (L,
    E, ...) expert stacks across unchanged."""
    got = {name: tuple(t.shape) for name, t in pair.model.named_parameters()}
    assert got == jflat_shapes(pair.jmodel.param_shapes())
    assert {k: tuple(t.shape) for k, t in convert.lm_params_from_jax(pair.jparams).items()} == got
    assert got["blocks.moe.wi_gate"] == (2, 4, 256, 512)  # (L, E, d, f)
    assert pair.model.param_count() == pair.jmodel.param_count()


def test_forward_matches_jax(pair):
    rng = np.random.default_rng(2)
    check_forward(pair, pair.batch(rng, 2, 40))


def test_prefill_and_decode_match_jax(pair):
    """Prefill at S = 40 (capacity 25 of 80 choices over 4 experts), then 4
    decode steps (capacity 1 at S = 1: nothing drops)."""
    rng = np.random.default_rng(3)
    check_prefill_decode(pair, pair.batch(rng, 2, 40), 48, 4, rng)


def test_loss_and_grads_match_jax(pair):
    rng = np.random.default_rng(4)
    metrics = check_loss_and_grads(pair, pair.batch(rng, 2, 32, "train"))
    assert float(metrics["aux"]) > 0


def test_serve_engine_matches_jax(pair):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, pair.cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 12, 9)]
    engine = ServeEngine(pair.model, max_batch=4, max_seq=32, eos_id=-1, device="cpu")
    jengine = JServeEngine(pair.jmodel, pair.jparams, max_batch=4, max_seq=32, eos_id=-1)
    got = engine.generate(prompts, max_new=5)
    want = jengine.generate(prompts, max_new=5)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]


def test_continuous_engine_matches_jax(pair):
    """Four requests over two slots, ragged max_new: refills mid-stream."""
    rng = np.random.default_rng(6)
    lens, max_new = (6, 6, 6, 6), (3, 5, 2, 4)  # one prompt width: one compile
    prompts = [rng.integers(2, pair.cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    engine = ContinuousEngine(pair.model, max_batch=2, max_seq=32, eos_id=-1, device="cpu")
    jengine = JContinuousEngine(pair.jmodel, pair.jparams, max_batch=2, max_seq=32, eos_id=-1)
    got = engine.serve([Request(p, m) for p, m in zip(prompts, max_new)])
    want = jengine.serve([JRequest(p, m) for p, m in zip(prompts, max_new)])
    assert all(r.done for r in got)
    assert [r.out for r in got] == [r.out for r in want]


def test_moe_wg_still_raises():
    """The pin of ``build(moe_wg=True)``'s old raise, now its check (the
    name is kept): on a (1, 1) mesh (a fake world of one rank, real
    tensors) the hand-written expert VJP with its gradient placement gives
    the loss and every gradient of ``moe_wg=False``, within GRAD_REL of
    each leaf's scale, and both equal the unsharded model's loss."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.models import build
    from repro_torch.sharding import activations as act
    from repro_torch.training import trainer
    from torch_family_pairs import GRAD_REL, close_scaled

    cfg = get_config(ARCH).reduced()
    plain = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(8)
    toks = rng.integers(2, cfg.vocab_size, size=(2, 17)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "targets": torch.from_numpy(toks[:, 1:].copy())}
    want_loss, _ = plain.loss(plain.master_params(), batch)
    out = {}
    mesh = make_fake_mesh((1, 1), ("data", "model"))
    try:
        for wg in (False, True):
            model = build(cfg, act_axes=("data",), mesh=mesh, moe_wg=wg)
            assert (model._wg_constrain() is not None) == wg
            params = model.distribute_params(plain.master_params())
            (loss, _), grads = trainer.value_and_grad(model.loss, has_aux=True)(params, batch)
            out[wg] = float(act.full(loss)), {p: act.full(g) for p, g in pr.flatten(grads)}
    finally:
        dist.destroy_process_group()
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    assert out[False][0] == pytest.approx(float(want_loss), rel=1e-6)
    for path, g in out[False][1].items():
        close_scaled(out[True][1][path], g, GRAD_REL, ".".join(path))


def test_expert_ffn_vjp_matches_jax(pair):
    """``_expert_ffn`` through the hand-written VJP (identity
    ``wg_constrain``) against the reference's ``custom_vjp`` path: the
    output within LAYER_TOL, the gradients of the buffer and of the three
    expert weights within GRAD_REL (1e-4) of each one's scale."""
    from torch_family_pairs import GRAD_REL, close_scaled

    cfg, jcfg = pair.cfg, pair.jcfg
    rng = np.random.default_rng(9)
    w = {k: v[0].numpy() for k, v in pair.model.master_params()["blocks"]["moe"].items()
         if k in ("wi_gate", "wi_up", "wo")}
    buf = rng.normal(size=(2, cfg.n_experts, 6, cfg.d_model)).astype(np.float32)
    cot = rng.normal(size=buf.shape).astype(np.float32)

    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    tbuf = torch.from_numpy(buf).requires_grad_()
    y = moe._expert_ffn(cfg, leaves, tbuf, wg_constrain=lambda g: g)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), [tbuf, *leaves.values()])

    def jloss(b, ws):
        out = jmoe._expert_ffn(jcfg, ws, b, wg_constrain=lambda g: g)
        return jnp.sum(out * cot), out

    (_, jy), (jgb, jgw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(buf), {k: jnp.asarray(v) for k, v in w.items()})
    close(y.detach(), jy, LAYER_TOL)
    close_scaled(grads[0], jgb, GRAD_REL, "buf")
    for g, name in zip(grads[1:], leaves):
        close_scaled(g, jgw[name], GRAD_REL, name)
