"""The port's LM serving slice (dense family) on the CPU, against the JAX
package.

Every input is drawn from numpy with a seed; every model's parameters are
the reference's own (``Model.init`` with a ``jax.random`` key), carried
across by ``convert.lm_params_from_jax``, and each reference model is
built once per file (module-scoped fixtures). Configs: qwen3-0.6b reduced
(qk-norm, swiglu, GQA 4:2), its sliding-window variant (window 64, with
prompts longer than the window, so prefill rolls the ring buffer), and
starcoder2-7b reduced (biases, tanh-gelu, GQA 4:1). All float32.

Tolerances:
  * K5's plain version against JAX ``ref.attention`` and the Pallas
    kernel in interpret mode: 1e-5 absolute and relative (the same f32
    softmax, other summation orders).
  * layers (``rmsnorm``, ``rope``, ``attn_apply``, ``attn_decode``):
    1e-5 absolute and relative on O(1) values.
  * whole-model logits (forward, prefill, six decode steps): 1e-4
    absolute and relative -- two layers of f32 matmuls of length <= 512
    summed in another order than XLA's, on logits of O(1).
  * generated tokens: exactly equal (greedy argmax of those logits; the
    top-2 margins here are far above 1e-4).
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.flash_attention import ops as jflash_ops
from repro.kernels.flash_attention import ref as jflash_ref
from repro.models import build as jbuild
from repro.models import layers as jly
from repro.serving.continuous import ContinuousEngine as JContinuousEngine
from repro.serving.continuous import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.launch import serve as serve_launch
from repro_torch.models import build, for_shape, layers as ly
from repro_torch.serving.continuous import ContinuousEngine, Request, _splice
from repro_torch.serving.engine import ServeEngine

flash_attention_ops = flash_ops.flash_attention
ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.append(str(ROOT))  # chip_smoke.py

# One intra-op thread: the suite runs in parallel workers on a shared
# machine (see test_torch_kernels.py).
torch.set_num_threads(1)

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("qwen3", "qwen3-sliding", "starcoder2")


def _cfg(name: str, get):
    if name == "qwen3":
        return get("qwen3-0.6b").reduced()
    if name == "qwen3-sliding":
        return dataclasses.replace(get("qwen3-0.6b").reduced(), attention="sliding",
                                   window=64)
    return get("starcoder2-7b").reduced()


class Pair:
    """One reduced config built in both packages on the same parameters."""

    def __init__(self, name: str, seed: int):
        self.cfg = _cfg(name, get_config)
        self.jcfg = _cfg(name, jget_config)
        self.jmodel = jbuild(self.jcfg)
        self.jparams = self.jmodel.init(jax.random.PRNGKey(seed))
        self.model = build(self.cfg).load_params(
            convert.lm_params_from_jax(self.jparams), device="cpu")
        # One compile each: eager JAX compiles every primitive anew.
        self.jforward = jax.jit(self.jmodel.forward)
        self.jprefill = jax.jit(self.jmodel.prefill, static_argnums=2)
        self.jdecode = jax.jit(self.jmodel.decode_step)

    def layer_params(self, i: int):
        jp = jax.tree.map(lambda t: t[i], self.jparams["blocks"])
        return jp, self.model.compute_params()[1][i]


@pytest.fixture(scope="module")
def pairs():
    return {name: Pair(name, seed) for seed, name in enumerate(ARCHS)}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _close(got, want, tol) -> None:
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _tokens(rng, cfg, b, s) -> np.ndarray:
    return rng.integers(2, cfg.vocab_size, size=(b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# K5: the plain version and the router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax(causal):
    rng = np.random.default_rng(5)
    b, s, h, kv, hd = 2, 128, 4, 2, 32
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    before = flash_kernel.LAUNCHES
    got = flash_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    assert flash_kernel.LAUNCHES == before  # a CPU tensor takes the plain version
    want_ref = jflash_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal, use_pallas=False)
    want_pallas = jflash_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=causal, block_q=64, block_k=64,
                                             use_pallas=True)
    _close(got, want_ref, LAYER_TOL)
    _close(got, want_pallas, LAYER_TOL)
    # the flattened (BH, S, hd) layout against JAX's ref.attention itself
    flat = rng.normal(size=(3, 3, 64, 16)).astype(np.float32)
    _close(flash_ref.attention(*map(torch.from_numpy, flat), causal=causal),
           jflash_ref.attention(*map(jnp.asarray, flat), causal=causal), LAYER_TOL)


def test_flash_kernel_refuses_cpu_tensors():
    x = torch.zeros((2, 64, 128))
    before = flash_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention(x, x, x)
    assert flash_kernel.LAUNCHES == before


def _attention_f32(q, k, v, drop):
    """Causal attention on the bf16 inputs in float32 throughout (no
    rounding of q.k or P, as the kernel keeps them), with the (row, key)
    pairs where ``drop`` is true masked out too; rounded to bf16 once."""
    s, hd = q.shape[1:]
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / hd**0.5
    i, j = torch.arange(s)[:, None], torch.arange(s)[None, :]
    logits = torch.where((j <= i) & ~drop(i, j), logits, flash_ref.NEG_INF)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(logits, -1), v.float()).to(q.dtype)


@pytest.mark.parametrize("variant, caught", [
    ("f32 logits and P", False),
    ("keys 512-575 skipped by rows >= 1024", True),
    ("key 0 dropped by rows >= 1024", True),
])
def test_flash_tolerance_separates_rounding_from_faults(variant, caught):
    # chip_smoke.py holds K5 to its plain version element by element on each
    # row's scale; a legitimately different rounding passes, faults that touch
    # only late rows or one key of a long row do not.
    chip_smoke = importlib.import_module("chip_smoke")
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2048, 128)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    drop = {
        "f32 logits and P": lambda i, j: torch.zeros((), dtype=torch.bool),
        "keys 512-575 skipped by rows >= 1024": lambda i, j: (i >= 1024) & (j >= 512) & (j < 576),
        "key 0 dropped by rows >= 1024": lambda i, j: (i >= 1024) & (j == 0),
    }[variant]
    share = chip_smoke.flash_share(_attention_f32(q, k, v, drop),
                                   flash_ref.attention(q, k, v, causal=True))
    assert (share > 1.0) == caught, share


def test_flash_faults_edit_the_kernel_source():
    # tools/flash_faults.py plants each fault by a text edit of the K5 source;
    # every edit must find its text there exactly once.
    spec = importlib.util.spec_from_file_location("flash_faults", ROOT / "tools" / "flash_faults.py")
    faults = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(faults)
    source = (ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu").read_text()
    assert set(faults.FAULTS) >= {"none", "skip_tile", "no_rescale", "one_key", "f32_skip_tile"}
    for name, (_, _, edits) in faults.FAULTS.items():
        assert bool(edits) == (name != "none")
        for old, _ in edits:
            assert source.count(old) == 1, name


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    _close(ly.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           jly.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)), LAYER_TOL)
    pos = rng.integers(0, 3000, size=(2, 9)).astype(np.int32)
    _close(ly.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           jly.rope(jnp.asarray(x), jnp.asarray(pos), 1e6), LAYER_TOL)


@pytest.mark.parametrize("route", ["plain", "chunked", "flash-plain"])
def test_attn_apply(pairs, route, monkeypatch):
    """The three prefill routes of ``attn_apply``: ``_sdpa``,
    ``_sdpa_chunked`` (S = 2048, two 1024-row chunks) and K5's router
    (forced on for a CPU tensor, so it runs K5's plain version)."""
    pair = pairs["qwen3"]
    jp, p = pair.layer_params(0)
    s = 2048 if route == "chunked" else 64
    x = np.random.default_rng(1).normal(size=(1, s, pair.cfg.d_model)).astype(np.float32)
    routed = []
    if route == "flash-plain":
        monkeypatch.setattr(ly, "_use_flash_kernel", lambda *a: True)
        monkeypatch.setattr(flash_ops, "flash_attention", lambda *a, **kw: routed.append(1) or
                            flash_attention_ops(*a, **kw))
    before = flash_kernel.LAUNCHES
    y, (k, v) = ly.attn_apply(pair.cfg, p["attn"], torch.from_numpy(x),
                              chunked=route == "chunked", return_kv=True)
    assert flash_kernel.LAUNCHES == before
    assert len(routed) == (route == "flash-plain")
    japply = jax.jit(functools.partial(jly.attn_apply, pair.jcfg,
                                       chunked=route == "chunked", return_kv=True))
    jy, (jk, jv) = japply(jp["attn"], jnp.asarray(x))
    _close(y, jy, LAYER_TOL)
    _close(k, jk, LAYER_TOL)
    _close(v, jv, LAYER_TOL)


@pytest.mark.parametrize("arch", ["qwen3", "qwen3-sliding"])
def test_attn_decode_per_slot_positions(pairs, arch):
    pair = pairs[arch]
    cfg = pair.cfg
    jp, p = pair.layer_params(1)
    rng = np.random.default_rng(2)
    b, max_seq = 3, 96
    shape = ly.attn_cache_shape(cfg, b, max_seq)["k"]
    cache = {n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 37, 90], np.int32)  # past the 64-slot ring in the sliding case
    tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    y, new = ly.attn_decode(cfg, p["attn"], torch.from_numpy(x), tcache, torch.from_numpy(pos))
    jy, jnew = jax.jit(functools.partial(jly.attn_decode, pair.jcfg))(
        jp["attn"], jnp.asarray(x), {n: jnp.asarray(c) for n, c in cache.items()},
        jnp.asarray(pos))
    _close(y, jy, LAYER_TOL)
    for n in ("k", "v"):
        assert new[n] is tcache[n]  # written in place
        _close(new[n], jnew[n], LAYER_TOL)


# ---------------------------------------------------------------------------
# Model: forward, prefill, decode
# ---------------------------------------------------------------------------

def test_param_tree_mirrors_jax(pairs):
    for pair in pairs.values():
        jflat = {".".join(str(k.key) for k in path): leaf.shape
                 for path, leaf in jax.tree_util.tree_flatten_with_path(pair.jparams)[0]}
        got = {name: tuple(t.shape) for name, t in pair.model.named_parameters()}
        assert got == jflat
        assert pair.model.param_count() == pair.jmodel.param_count()
    assert build(get_config("qwen3-0.6b")).param_count() == 751_632_384


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode(pairs, arch):
    """Forward logits, then prefill (logits and the whole cache) and six
    decode steps, against the reference; the sliding variant's prompt (80)
    is longer than its 64-slot ring."""
    pair = pairs[arch]
    rng = np.random.default_rng(3)
    b, s, max_seq = 2, 80, 96
    tokens = _tokens(rng, pair.cfg, b, s)
    logits, aux = pair.model.forward({"tokens": torch.from_numpy(tokens)})
    jlogits, _ = pair.jforward(pair.jparams, {"tokens": jnp.asarray(tokens)})
    _close(logits, jlogits, MODEL_TOL)
    assert float(aux) == 0.0

    last, cache = pair.model.prefill({"tokens": torch.from_numpy(tokens)}, max_seq)
    jlast, jcache = pair.jprefill(pair.jparams, {"tokens": jnp.asarray(tokens)}, max_seq)
    _close(last, jlast, MODEL_TOL)
    for n in ("k", "v"):
        assert cache["layers"][n].shape == jcache["layers"][n].shape
        _close(cache["layers"][n], jcache["layers"][n], MODEL_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    for _ in range(6):
        tok = _tokens(rng, pair.cfg, b, 1)
        logits, cache = pair.model.decode_step(cache, {"tokens": torch.from_numpy(tok)})
        jlogits, jcache = pair.jdecode(pair.jparams, jcache, {"tokens": jnp.asarray(tok)})
        _close(logits, jlogits, MODEL_TOL)
    for n in ("k", "v"):
        _close(cache["layers"][n], jcache["layers"][n], MODEL_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

def test_serve_engine_matches_jax(pairs):
    pair = pairs["qwen3"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, pair.cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 12, 9)]
    engine = ServeEngine(pair.model, max_batch=4, max_seq=48, eos_id=-1, device="cpu")
    jengine = JServeEngine(pair.jmodel, pair.jparams, max_batch=4, max_seq=48, eos_id=-1)
    got = engine.generate(prompts, max_new=6)
    want = jengine.generate(prompts, max_new=6)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]


def test_continuous_engine_matches_jax(pairs):
    """Five requests over two slots with ragged max_new: refills happen
    mid-stream; every request's tokens equal the reference engine's."""
    pair = pairs["qwen3"]
    rng = np.random.default_rng(6)
    lens, max_new = (5, 9, 5, 9, 5), (3, 6, 2, 5, 4)  # two prompt widths: two compiles
    prompts = [rng.integers(2, pair.cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    engine = ContinuousEngine(pair.model, max_batch=2, max_seq=48, eos_id=-1, device="cpu")
    jengine = JContinuousEngine(pair.jmodel, pair.jparams, max_batch=2, max_seq=48,
                                eos_id=-1)
    got = engine.serve([Request(p, m) for p, m in zip(prompts, max_new)])
    want = jengine.serve([JRequest(p, m) for p, m in zip(prompts, max_new)])
    assert all(r.done for r in got)
    assert [r.out for r in got] == [r.out for r in want]
    assert [len(r.out) for r in got] == list(max_new)


def test_splice_locates_batch_axis(pairs):
    model = pairs["qwen3"].model
    big = model.init_cache(3, 16)
    one = {"layers": {n: t + 1 for n, t in model.init_cache(1, 16)["layers"].items()},
           "pos": torch.ones(1, dtype=torch.int32)}
    out = _splice(big, one, 1)
    assert out is big
    k = out["layers"]["k"]
    assert float(k[:, 0].abs().sum()) == 0 and float(k[:, 2].abs().sum()) == 0
    assert bool((k[:, 1] == 1).all())
    assert out["pos"].tolist() == [0, 1, 0]


# ---------------------------------------------------------------------------
# Entry points and what is not ported
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda(pairs, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-0.6b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(cfg).init(torch.Generator().manual_seed(0))
    model = pairs["qwen3"].model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, max_batch=1, max_seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousEngine(model, max_batch=1, max_seq=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_launch.main(["--arch", "qwen3-0.6b", "--reduced"])
    serve_launch.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                       "--batch", "2", "--max-new", "3"])
    assert "6 tokens" in capsys.readouterr().out


def test_unported_parts_raise():
    for arch in ("qwen3-moe-30b-a3b", "xlstm-1.3b", "hubert-xlarge", "paligemma-3b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build(get_config(arch).reduced())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(get_config("qwen3-0.6b").reduced(), seq_shard=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(get_config("qwen3-0.6b").reduced()).loss({})
    assert for_shape(get_config("qwen3-0.6b"), "long_500k").attention == "sliding"
    assert for_shape(get_config("qwen3-0.6b"), "decode_32k").attention == "full"
