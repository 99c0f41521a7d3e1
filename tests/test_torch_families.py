"""The port's xLSTM (ssm), audio and vlm families on the CPU, against the
JAX package.

Every input is drawn from numpy with a seed; every model's parameters are
drawn once by the port and handed to the reference as arrays
(``tests/torch_family_pairs.py``); each reference model is built once for
the file (module fixtures) and each of its functions jitted once.
Configs, reduced: xlstm-1.3b (2 blocks: one super-block of one mLSTM and
one sLSTM, d_model 256, 4 heads), hubert-xlarge (a 2-layer bidirectional encoder, biases,
tanh-gelu, frames of 64), paligemma-3b (2 layers, 16 patches before the
text under the prefix-LM mask, geglu, GQA 4:1). All float32 unless a
test says otherwise.

Tolerances (``tests/torch_family_pairs.py``): logits and caches 1e-4
(MODEL_TOL), gradients 1e-4 of each leaf's scale (GRAD_REL), losses 1e-5
relative; generated tokens equal. Two more, stated at their tests: the
sLSTM prefill's hoisted input projections against the per-step form, and
sLSTM in bfloat16.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import InputShape as JInputShape
from repro.data import synthetic as jsynthetic
from repro.models import xlstm as jxl
from repro.serving.continuous import ContinuousEngine as JContinuousEngine
from repro.serving.continuous import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import pipeline, synthetic
from repro_torch.models import xlstm as xl
from repro_torch.serving.continuous import ContinuousEngine, Request, _splice
from repro_torch.serving.engine import ServeEngine
from torch_family_pairs import (
    Pair,
    check_forward,
    check_loss_and_grads,
    check_prefill_decode,
    close_scaled,
    jflat_shapes,
)

# One intra-op thread: the suite runs in parallel workers on a shared
# machine (see test_torch_kernels.py).
torch.set_num_threads(1)

ARCHS = {"xlstm": "xlstm-1.3b", "hubert": "hubert-xlarge", "paligemma": "paligemma-3b"}


@pytest.fixture(scope="module")
def pairs():
    return {name: Pair(arch, seed) for seed, (name, arch) in enumerate(ARCHS.items())}


# ---------------------------------------------------------------------------
# Forward, loss and gradients: every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(ARCHS))
def test_forward_matches_jax(pairs, name):
    """S = 40 positions (paligemma: 16 patches + 24 tokens; xLSTM: two
    mLSTM chunks of 32, the second ragged)."""
    pair = pairs[name]
    check_forward(pair, pair.batch(np.random.default_rng(1), 2, 40))


@pytest.mark.parametrize("name", list(ARCHS))
def test_loss_and_grads_match_jax(pairs, name):
    """hubert: the cross-entropy over the batch's mask only; paligemma: over
    the text positions only (the logits of the 16 patches are not read)."""
    pair = pairs[name]
    batch = pair.batch(np.random.default_rng(2), 2, 32, "train")
    if name == "hubert":
        assert 0 < batch["mask"].sum() < batch["mask"].size
    if name == "paligemma":
        assert batch["targets"].shape == (2, 32 - pair.cfg.n_patches)
    check_loss_and_grads(pair, batch)


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["xlstm", "paligemma"])
def test_prefill_and_decode_match_jax(pairs, name):
    """Prefill (last logits and every cache leaf: the xLSTM's stacked
    (n_super, period - 1, B, ...) mLSTM and (n_super, B, ...) sLSTM
    states; paligemma's K/V of patches and text), then 4 decode steps."""
    pair = pairs[name]
    rng = np.random.default_rng(3)
    check_prefill_decode(pair, pair.batch(rng, 2, 40), 48, 4, rng)


def test_encoder_has_no_decode_and_no_engine(pairs):
    model = pairs["hubert"].model
    with pytest.raises(ValueError, match="encoder-only"):
        model.decode_step({}, {"tokens": torch.zeros((1, 1), dtype=torch.int32)})
    for name in ("hubert", "paligemma"):
        for engine in (ServeEngine, ContinuousEngine):
            with pytest.raises(ValueError, match="feed tokens only"):
                engine(pairs[name].model, max_batch=1, max_seq=8, device="cpu")


def test_xlstm_engines_match_jax(pairs):
    """Static: three prompts left-padded in 4 slots. Continuous: four
    requests over two slots, ragged max_new, so refills splice a batch-1
    xLSTM cache into the live one mid-stream."""
    pair = pairs["xlstm"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, pair.cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 12, 9)]
    got = ServeEngine(pair.model, max_batch=4, max_seq=32, eos_id=-1,
                      device="cpu").generate(prompts, max_new=5)
    want = JServeEngine(pair.jmodel, pair.jparams, max_batch=4, max_seq=32,
                        eos_id=-1).generate(prompts, max_new=5)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]

    prompts = [rng.integers(2, pair.cfg.vocab_size, size=6).astype(np.int32) for _ in range(4)]
    max_new = (3, 5, 2, 4)
    got = ContinuousEngine(pair.model, max_batch=2, max_seq=32, eos_id=-1, device="cpu").serve(
        [Request(p, m) for p, m in zip(prompts, max_new)])
    want = JContinuousEngine(pair.jmodel, pair.jparams, max_batch=2, max_seq=32,
                             eos_id=-1).serve([JRequest(p, m) for p, m in zip(prompts, max_new)])
    assert all(r.done for r in got)
    assert [r.out for r in got] == [r.out for r in want]


def test_splice_finds_the_xlstm_batch_axis(pairs):
    """``_splice`` finds the batch axis of the xLSTM cache by shape
    difference, unchanged: axis 2 of the mLSTM leaves (n_super, period -
    1, B, ...), axis 1 of the sLSTM leaves (n_super, B, ...)."""
    model = pairs["xlstm"].model
    big = model.init_cache(3, 16)
    one = model.init_cache(1, 16)
    for path, t in convert.lm_params.flatten(one):
        t.fill_(1)
    out = _splice(big, one, 1)
    assert out is big
    ml, sl = out["supers"]["mlstm"], out["supers"]["slstm"]
    assert ml["state"].shape[:3] == (1, 1, 3) and sl["c"].shape[:2] == (1, 3)
    for t, axis in ((ml["conv"], 2), (ml["state"], 2), (sl["c"], 1), (sl["n"], 1),
                    (sl["h"], 1)):
        for slot in range(3):
            want = 1.0 if slot == 1 else 0.0
            assert bool((t.select(axis, slot) == want).all())
    assert out["pos"].tolist() == [0, 1, 0]


# ---------------------------------------------------------------------------
# sLSTM: the hoisted projections, dtypes
# ---------------------------------------------------------------------------

def test_slstm_prefill_equals_its_decode_steps(pairs):
    """``slstm_apply`` makes each gate's input projection for the whole
    sequence at once; ``slstm_decode`` makes it per step, as the
    reference's scan does. Over 24 steps their outputs and final states
    agree within 2e-6 of their scale: the hoist costs only one f32
    matmul's summation order (M = B S rows against M = B)."""
    pair = pairs["xlstm"]
    cfg = pair.cfg
    p = pair.model.compute_params()[1][0][1]
    u = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 24, cfg.d_model))
                         .astype(np.float32))
    out, state = xl.slstm_apply(cfg, p, u, return_cache=True)
    cache = {n: torch.zeros(s) for n, s in xl.slstm_cache_shape(cfg, 2).items()}
    steps = []
    for t in range(u.shape[1]):
        y, cache = xl.slstm_decode(cfg, p, u[:, t:t + 1], cache)
        steps.append(y)
    close_scaled(out, torch.cat(steps, dim=1), 2e-6, "out")
    for n in ("c", "n", "h"):
        close_scaled(state[n], cache[n], 2e-6, n)


def test_slstm_bf16_follows_jax_promotion(pairs):
    """One sLSTM block in bfloat16 against the reference's: the state and
    the gate sums are float32 (the reference promotes the bf16 recurrent
    weights to the float32 state), the outputs bf16. Outputs within 2^-6 of
    their scale, states within 2^-7: the two packages round the same
    bf16 products, apart from the summation order of each bf16 matmul and
    a few ulps that the recurrence carries."""
    pair = pairs["xlstm"]
    cfg, jcfg = pair.cfg, pair.jcfg
    p = jax.tree.map(lambda t: t[0], pair.jparams["supers"]["slstm"])
    tp = convert.lm_params.unflatten(
        (path, torch.from_numpy(np.array(leaf))) for path, leaf in convert.lm_params.flatten(p))
    u = np.random.default_rng(6).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    out, state = xl.slstm_apply(cfg, tp, torch.from_numpy(u).to(torch.bfloat16),
                                return_cache=True)
    jout, jstate = jax.jit(lambda pp, uu: jxl.slstm_apply(jcfg, pp, uu, return_cache=True))(
        p, jnp.asarray(u, jnp.bfloat16))
    assert out.dtype == torch.bfloat16
    assert all(state[n].dtype == torch.float32 for n in ("c", "n", "h"))
    assert all(jstate[n].dtype == jnp.float32 for n in ("c", "n", "h"))
    close_scaled(out, jout, 2.0**-6, "out")
    for n in ("c", "n", "h"):
        close_scaled(state[n], jstate[n], 2.0**-7, n)


# ---------------------------------------------------------------------------
# Data and conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["hubert-xlarge", "paligemma-3b", "xlstm-1.3b"])
def test_batches_follow_the_reference(arch):
    """``batch_specs`` equals the reference's leaf for leaf (shapes and
    dtypes) for every kind; ``make_batch`` draws leaves of those specs (the
    audio mask at about 8%); ``BatchStream`` streams them."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for kind in ("train", "prefill", "decode"):
        got = synthetic.batch_specs(cfg, InputShape("t", 512, 2, kind))
        want = jsynthetic.batch_specs(jcfg, JInputShape("t", 512, 2, kind))
        assert {k: (s.shape, str(s.dtype).split(".")[-1]) for k, s in got.items()} == {
            k: (tuple(s.shape), str(s.dtype)) for k, s in want.items()}
    small = cfg.reduced()
    specs = synthetic.batch_specs(small, InputShape("t", 256, 4, "train"))
    stream = pipeline.BatchStream(small, InputShape("t", 256, 4, "train"), seed=1, device="cpu")
    batch = next(iter(stream))
    assert {k: (tuple(t.shape), t.dtype) for k, t in batch.items()} == {
        k: (s.shape, s.dtype) for k, s in specs.items()}
    assert all(torch.equal(batch[k], stream.batch_at(0)[k]) for k in batch)
    if small.modality == "audio":
        assert 0.04 < float(batch["mask"].mean()) < 0.12
        assert set(batch["mask"].unique().tolist()) == {0.0, 1.0}
    else:
        assert torch.equal(batch["targets"][:, :-1], batch["tokens"][:, 1:])


def test_convert_carries_the_family_trees(pairs):
    """The parameter trees are the reference's path for path (its
    ``param_shapes``), and ``lm_params_from_jax`` keeps the nested
    ``supers`` tree and the audio frontend under those paths, shapes
    unchanged, and loads back into the model."""
    for name in ARCHS:
        pair = pairs[name]
        want = jflat_shapes(pair.jmodel.param_shapes())
        assert {k: tuple(t.shape) for k, t in pair.model.named_parameters()} == want
        state = convert.lm_params_from_jax(pair.jparams)
        assert {k: tuple(t.shape) for k, t in state.items()} == want
        assert pair.model.param_count() == pair.jmodel.param_count()
        type(pair.model)(pair.cfg).load_params(state, device="cpu")
    assert "supers.mlstm.wq" in convert.lm_params_from_jax(pairs["xlstm"].jparams)
    assert "frontend_proj" in convert.lm_params_from_jax(pairs["hubert"].jparams)
