"""The port's hybrid LM serving slice (zamba2-7b family, K6) on the CPU,
against the JAX package.

Every input is drawn from numpy with a seed; the model's parameters are
the reference's own (``Model.init`` with a ``jax.random`` key), carried
across by ``convert.lm_params_from_jax``, and the reference model is built
and compiled once for the file (a module-scoped fixture). Config:
zamba2-7b reduced to 5 Mamba2 blocks with a shared attention site every 2
(two full groups and a remainder group of one), d_model 256, 16 SSM heads
of 32 with state 16, chunk 32, float32.

Tolerances:
  * K6's plain version and ``ssd_scan`` against JAX ``ref.ssd_chunk``, the
    Pallas kernel in interpret mode and JAX ``ssd_scan`` (both routes):
    float32 1e-4 absolute and relative (JAX's own kernel-vs-ref tolerance
    in ``tests/test_kernels_ssd.py``: the same products in other orders,
    through exp of cumulative sums up to ~100); bfloat16 5e-2 (the same
    file's: each package rounds each product to bf16, 2^-9, and the sums of
    up to 64 rounded terms may differ by a few such roundings of O(1)
    values).
  * ``scan_core``, ``mamba2_apply`` / ``mamba2_decode`` and its cache:
    1e-5 absolute and relative (f32 on O(1) values).
  * K6's route forced on in ``_ssm_inner`` (the plain chunk step of
    ``ssd_scan``) against the ``scan_core`` route: 1e-5 (two f32
    decompositions of one recurrence).
  * whole-model logits (forward, prefill, decode steps) and cache leaves:
    1e-4 absolute and relative, as ``tests/test_torch_lm.py``.
  * generated tokens: exactly equal.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.ssd import kernel as jssd_kernel
from repro.kernels.ssd import ops as jssd_ops
from repro.kernels.ssd import ref as jssd_ref
from repro.models import build as jbuild
from repro.models import scan_core as jscan_core
from repro.models import ssm as jssm
from repro.serving.continuous import ContinuousEngine as JContinuousEngine
from repro.serving.continuous import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.launch import serve as serve_launch
from repro_torch.models import build, scan_core, ssm
from repro_torch.serving.continuous import ContinuousEngine, Request, _splice
from repro_torch.serving.engine import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.append(str(ROOT))  # chip_smoke.py

# One intra-op thread: the suite runs in parallel workers on a shared
# machine (see test_torch_kernels.py).
torch.set_num_threads(1)

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _cfg(get):
    return dataclasses.replace(get("zamba2-7b").reduced(), n_layers=5, attn_every=2)


class Pair:
    """The reduced hybrid config built in both packages on the same
    parameters."""

    def __init__(self, seed: int = 0):
        self.cfg, self.jcfg = _cfg(get_config), _cfg(jget_config)
        self.jmodel = jbuild(self.jcfg)
        self.jparams = self.jmodel.init(jax.random.PRNGKey(seed))
        self.model = build(self.cfg).load_params(
            convert.lm_params_from_jax(self.jparams), device="cpu")
        self.jforward = jax.jit(self.jmodel.forward)
        self.jprefill = jax.jit(self.jmodel.prefill, static_argnums=2)
        self.jdecode = jax.jit(self.jmodel.decode_step)

    def mamba_params(self, g: int, i: int):
        """Mamba2 block i of group g in both packages (the port's compute
        copy, float32 here)."""
        jp = jax.tree.map(lambda t: t[g, i], self.jparams["mamba_groups"])
        return jp, self.model.compute_params()[1][g][i]


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _close(got, want, tol) -> None:
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _t(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype)


def _j(a: np.ndarray, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _ssd_inputs(rng, bh, s, dk, dv):
    """q, k, v ~ N(0, 1/4) and ld = -softplus(N(0, 1)), as the JAX SSD tests
    draw them, in float32 numpy."""
    q, k = (0.5 * rng.normal(size=(bh, s, dk)) for _ in range(2))
    v = 0.5 * rng.normal(size=(bh, s, dv))
    ld = -np.logaddexp(rng.normal(size=(bh, s)), 0.0)
    return [a.astype(np.float32) for a in (q, k, v, ld)]


# ---------------------------------------------------------------------------
# K6: the plain version, the router and the two-pass scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_plain_matches_jax(dtype):
    rng = np.random.default_rng(0)
    bh, nc, l, dk, dv = 3, 2, 32, 16, 32
    q, k, v, ld = _ssd_inputs(rng, bh * nc, l, dk, dv)
    h_in = rng.normal(size=(bh * nc, dk, dv)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    got = ssd_ref.ssd_chunk(*(_t(a, tdt) for a in (q, k, v, ld)), _t(h_in))
    want = jax.jit(jssd_ref.ssd_chunk)(*(_j(a, jdt) for a in (q, k, v, ld)), _j(h_in))
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        _close(g, w, tol)
    # the kernel's batched-over-chunks layout, against the Pallas kernel in
    # interpret mode
    split = [a.reshape(bh, nc, *a.shape[1:]) for a in (q, k, v, ld, h_in)]
    got = ssd_ref.ssd_chunks(*(_t(a, tdt) for a in split[:4]), _t(split[4]))
    want = jssd_kernel.ssd_chunks(*(_j(a, jdt) for a in split[:4]), _j(split[4]),
                                  interpret=True)
    assert got[0].shape == (bh, nc, l, dv) and got[1].shape == (bh, nc, dk, dv)
    for g, w in zip(got, want):
        _close(g, w, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh, s, dk, dv, chunk", [
    (2, 64, 16, 32, 16), (3, 128, 64, 64, 32), (1, 256, 32, 128, 64)])
def test_ssd_scan_matches_jax(bh, s, dk, dv, chunk, dtype):
    """The JAX SSD tests' shapes: the port's scan (a CPU tensor takes the
    plain chunk step) against JAX's through the Pallas kernel in
    interpret mode and through its ref."""
    q, k, v, ld = _ssd_inputs(np.random.default_rng(1), bh, s, dk, dv)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    before = ssd_kernel.LAUNCHES
    y, state = ssd_ops.ssd_scan(*(_t(a, tdt) for a in (q, k, v, ld)), chunk=chunk)
    assert ssd_kernel.LAUNCHES == before
    assert y.dtype == tdt and state.dtype == torch.float32
    for use_pallas in (True, False):
        jy, jstate = jssd_ops.ssd_scan(*(_j(a, jdt) for a in (q, k, v, ld)), chunk=chunk,
                                       use_pallas=use_pallas)
        _close(y, jy, tol)
        _close(state, jstate, tol)


def test_ssd_kernel_refuses_cpu_tensors():
    bh, nc, l, d = 2, 1, 16, 64
    x = torch.zeros((bh, nc, l, d))
    args = (x, x, x, torch.zeros((bh, nc, l)), torch.zeros((bh, nc, d, d)))
    before = ssd_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_chunks(*args)
    assert ssd_kernel.LAUNCHES == before
    # the router sends the same CPU tensors to the plain version
    y, state = ssd_ops.ssd_scan(x[:, 0], x[:, 0], x[:, 0], torch.zeros((bh, l)))
    assert y.shape == (bh, l, d) and state.shape == (bh, d, d)
    assert ssd_kernel.LAUNCHES == before


def _grouped_inputs(rng, g, nc, l, hg, dk, dv):
    """K6's grouped layout: q, k (G, NC, L, Dk), v (G, NC, L, Hg, Dv), ld (G,
    NC, L, Hg), h_in (G, Hg, NC, Dk, Dv), drawn as _ssd_inputs draws them."""
    q, k = (0.5 * rng.normal(size=(g, nc, l, dk)) for _ in range(2))
    v = 0.5 * rng.normal(size=(g, nc, l, hg, dv))
    ld = -np.logaddexp(rng.normal(size=(g, nc, l, hg)), 0.0)
    h_in = rng.normal(size=(g, hg, nc, dk, dv))
    return [a.astype(np.float32) for a in (q, k, v, ld, h_in)]


def _expanded(q, k, v, ld, h_in):
    """The grouped inputs per head, (G * Hg, NC, L, ...) in (group, head)
    order, as the JAX kernel and ref take them."""
    g, nc, l, hg, dv = v.shape
    dk = q.shape[-1]

    def heads(a):  # q, k broadcast over the heads
        return np.broadcast_to(a[:, None], (g, hg, nc, l, dk)).reshape(g * hg, nc, l, dk)

    return (heads(q), heads(k), v.transpose(0, 3, 1, 2, 4).reshape(g * hg, nc, l, dv),
            ld.transpose(0, 3, 1, 2).reshape(g * hg, nc, l), h_in.reshape(g * hg, nc, dk, dv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_modes_plain_match_jax(dtype):
    """K6's states and outputs plain versions on the grouped layout against
    JAX ``ref.ssd_chunk`` and the Pallas kernel in interpret mode on the
    inputs expanded per head (the states with h_in = 0)."""
    g, nc, l, hg, dk, dv = 2, 2, 32, 3, 16, 32
    q, k, v, ld, h_in = _grouped_inputs(np.random.default_rng(8), g, nc, l, hg, dk, dv)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    states = ssd_ref.ssd_chunk_states(*(_t(a, tdt) for a in (k, v, ld)))
    y = ssd_ref.ssd_chunk_outputs(*(_t(a, tdt) for a in (q, k, v, ld)), _t(h_in))
    assert states.dtype == torch.float32 and states.shape == (g, hg, nc, dk, dv)
    assert y.dtype == tdt and y.shape == (g, nc, l, hg, dv) and y.is_contiguous()
    eq, ek, ev, eld, eh = _expanded(q, k, v, ld, h_in)
    zeros = np.zeros_like(eh)
    flat = [a.reshape(g * hg * nc, *a.shape[2:]) for a in (eq, ek, ev, eld, eh, zeros)]
    ref = jax.jit(jssd_ref.ssd_chunk)
    want_y, _ = ref(*(_j(a, jdt) for a in flat[:4]), _j(flat[4]))
    _, want_state = ref(*(_j(a, jdt) for a in flat[:4]), _j(flat[5]))
    pallas = [jssd_kernel.ssd_chunks(*(_j(a, jdt) for a in (eq, ek, ev, eld)), _j(hh),
                                     interpret=True) for hh in (eh, zeros)]
    for want in (want_state, pallas[1][1]):
        _close(states, np.asarray(want, np.float32).reshape(g, hg, nc, dk, dv), tol)
    for want in (want_y, pallas[0][0]):
        want = np.asarray(want.astype(jnp.float32)).reshape(g, hg, nc, l, dv)
        _close(y, want.transpose(0, 2, 3, 1, 4), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_grouped_matches_scan(dtype):
    """The grouped scan equals ``ssd_scan`` on the inputs expanded per head
    (the same plain chunk steps in the same order), and agrees with JAX
    ``ssd_scan`` on them (through the Pallas kernel in interpret mode and
    through its ref); it launches nothing for CPU tensors."""
    b, s, h, n, p, chunk = 2, 64, 3, 16, 32, 16
    rng = np.random.default_rng(9)
    q, k = (0.5 * rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    v = 0.5 * rng.normal(size=(b, s, h, p)).astype(np.float32)
    ld = -np.logaddexp(rng.normal(size=(b, s, h)), 0.0).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    before = ssd_kernel.LAUNCHES
    y, state = ssd_ops.ssd_scan_grouped(*(_t(a, tdt) for a in (q, k, v, ld)), chunk=chunk)
    assert ssd_kernel.LAUNCHES == before
    assert y.shape == (b, s, h, p) and y.dtype == tdt
    assert state.shape == (b, h, n, p) and state.dtype == torch.float32
    expand = [np.broadcast_to(a[:, :, None], (b, s, h, n)).transpose(0, 2, 1, 3)
              .reshape(b * h, s, n) for a in (q, k)]
    expand += [v.transpose(0, 2, 1, 3).reshape(b * h, s, p),
               ld.transpose(0, 2, 1).reshape(b * h, s)]
    ye, state_e = ssd_ops.ssd_scan(*(_t(a, tdt) for a in expand), chunk=chunk)
    assert torch.equal(y.transpose(1, 2).reshape(b * h, s, p), ye)
    assert torch.equal(state.reshape(b * h, n, p), state_e)
    for use_pallas in (True, False):
        jy, jstate = jssd_ops.ssd_scan(*(_j(a, jdt) for a in expand), chunk=chunk,
                                       use_pallas=use_pallas)
        _close(ye, jy, tol)
        _close(state_e, jstate, tol)


def test_ssd_mode_kernels_refuse_cpu_tensors():
    g, nc, l, hg, d = 2, 1, 16, 3, 64
    qk = torch.zeros((g, nc, l, d))
    v = torch.zeros((g, nc, l, hg, d))
    ld = torch.zeros((g, nc, l, hg))
    h_in = torch.zeros((g, hg, nc, d, d))
    before = ssd_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_chunk_states(qk, v, ld)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_chunk_outputs(qk, qk, v, ld, h_in)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.launch(ssd_kernel.STATES, None, qk, v, ld, None, None, h_in)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel._states_handed_h_in(qk, v, ld, h_in)
    assert ssd_kernel.LAUNCHES == before
    # the router sends the same CPU tensors to the plain versions
    y, state = ssd_ops.ssd_scan_grouped(qk[:, 0], qk[:, 0], v[:, 0], ld[:, 0])
    assert y.shape == (g, l, hg, d) and state.shape == (g, hg, d, d)
    assert ssd_kernel.LAUNCHES == before


@pytest.mark.parametrize("given", ["q", "h_in"])
def test_ssd_states_mode_takes_no_q_or_h_in(given):
    # Pass 1 reads neither C nor the incoming state: launch refuses them in
    # the states mode before it looks at the device, and launches nothing.
    g, nc, l, hg, d = 1, 1, 16, 2, 64
    qk = torch.zeros((g, nc, l, d))
    v = torch.zeros((g, nc, l, hg, d))
    ld = torch.zeros((g, nc, l, hg))
    state = torch.zeros((g, hg, nc, d, d))
    before = ssd_kernel.LAUNCHES
    with pytest.raises(ValueError, match="reads neither q nor h_in"):
        ssd_kernel.launch(ssd_kernel.STATES, qk if given == "q" else None, qk, v, ld,
                          state if given == "h_in" else None, None, state)
    assert ssd_kernel.LAUNCHES == before


# ---------------------------------------------------------------------------
# scan_core and the Mamba2 block
# ---------------------------------------------------------------------------

def test_scan_core_matches_jax():
    """A ragged S (40 over chunks of 16: the zero-pad branch) with an
    initial state, then one float32 decode step."""
    rng = np.random.default_rng(2)
    b, s, h, dk, dv = 2, 40, 3, 8, 16
    q, k = (rng.normal(size=(b, s, h, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    ld = -np.logaddexp(rng.normal(size=(b, s, h)), 0.0).astype(np.float32)
    h0 = rng.normal(size=(b, h, dk, dv)).astype(np.float32)
    y, state = scan_core.chunked_linear_attention(
        *(_t(a) for a in (q, k, v, ld)), chunk=16, initial_state=_t(h0))
    jy, jstate = jax.jit(lambda *a: jscan_core.chunked_linear_attention(
        *a[:4], chunk=16, initial_state=a[4]))(*(_j(a) for a in (q, k, v, ld, h0)))
    assert y.shape == (b, s, h, dv)
    _close(y, jy, LAYER_TOL)
    _close(state, jstate, LAYER_TOL)
    step = [a[:, 0] for a in (q, k, v, ld)]
    y1, s1 = scan_core.linear_attention_step(*(_t(a) for a in step), state)
    jy1, js1 = jax.jit(jscan_core.linear_attention_step)(*(_j(a) for a in step), jstate)
    _close(y1, jy1, LAYER_TOL)
    _close(s1, js1, LAYER_TOL)


def test_mamba2_apply_and_decode_match_jax(pair):
    cfg = pair.cfg
    jp, p = pair.mamba_params(1, 0)
    rng = np.random.default_rng(3)
    u = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    out, cache = ssm.mamba2_apply(cfg, p, _t(u), return_cache=True)
    jout, jcache = jax.jit(lambda p_, u_: jssm.mamba2_apply(pair.jcfg, p_, u_,
                                                            return_cache=True))(jp, _j(u))
    _close(out, jout, LAYER_TOL)
    for name in ("conv", "state"):
        assert tuple(cache[name].shape) == tuple(jcache[name].shape)
        assert tuple(cache[name].shape[1:]) == ssm.mamba2_cache_shape(cfg, 2)[name][1:]
        _close(cache[name], jcache[name], LAYER_TOL)
    jdecode = jax.jit(lambda p_, u_, c_: jssm.mamba2_decode(pair.jcfg, p_, u_, c_))
    for _ in range(3):
        u1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        out, cache = ssm.mamba2_decode(cfg, p, _t(u1), cache)
        jout, jcache = jdecode(jp, _j(u1), jcache)
        _close(out, jout, LAYER_TOL)
        for name in ("conv", "state"):
            _close(cache[name], jcache[name], LAYER_TOL)


def test_ssd_kernel_route_matches_scan_core(pair, monkeypatch):
    """K6's route through ``_ssm_inner`` (forced on for a CPU tensor, so
    ``ssd_scan_grouped`` runs K6's plain versions on the model's layout:
    log-decay rounded to the activations' type, a no-op in float32) against
    the scan_core route, at S = 64 over chunks of 32."""
    cfg = pair.cfg
    _, p = pair.mamba_params(0, 1)
    u = _t(np.random.default_rng(4).normal(size=(2, 64, cfg.d_model)).astype(np.float32))
    want, want_cache = ssm.mamba2_apply(cfg, p, u, return_cache=True)
    routed = []
    scan = ssd_ops.ssd_scan_grouped
    monkeypatch.setattr(ssm, "_use_ssd_kernel", lambda *a: True)

    def grouped(q, k, v, ld, **kw):
        # B and C once per batch row, v and ld in the model's layout
        routed.append((q.shape, k.shape, v.shape, ld.shape, kw))
        return scan(q, k, v, ld, **kw)

    monkeypatch.setattr(ssd_ops, "ssd_scan_grouped", grouped)
    got, got_cache = ssm.mamba2_apply(cfg, p, u, return_cache=True)
    n, h, pd = cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    assert routed == [((2, 64, n), (2, 64, n), (2, 64, h, pd), (2, 64, h),
                       {"chunk": cfg.ssm_chunk})]
    _close(got, want, LAYER_TOL)
    _close(got_cache["state"], want_cache["state"], LAYER_TOL)
    assert torch.equal(got_cache["conv"], want_cache["conv"])


def test_ssd_gate_follows_the_reference():
    x = torch.zeros(1)
    assert not ssm._use_ssd_kernel(x, None, 512, 256)  # a CPU tensor: the plain core
    meta = torch.empty(1, device="meta")
    # The gate reads the device type only; "cuda" is what passes it.
    cuda_like = type("T", (), {"device": torch.device("cuda")})()
    assert ssm._use_ssd_kernel(cuda_like, None, 512, 256)
    assert ssm._use_ssd_kernel(cuda_like, None, 77, 77)
    assert not ssm._use_ssd_kernel(cuda_like, None, 300, 256)  # ragged: scan_core pads
    assert not ssm._use_ssd_kernel(cuda_like, meta, 512, 256)  # an initial state


# ---------------------------------------------------------------------------
# Model: parameters, forward, prefill, decode
# ---------------------------------------------------------------------------

def test_param_tree_mirrors_jax(pair):
    jflat = {".".join(str(k.key) for k in path): leaf.shape
             for path, leaf in jax.tree_util.tree_flatten_with_path(pair.jparams)[0]}
    got = {name: tuple(t.shape) for name, t in pair.model.named_parameters()}
    assert got == jflat
    assert got["mamba_groups.in_proj"][:2] == (2, 2) and got["mamba_rest.A_log"][0] == 1
    state = convert.lm_params_from_jax(pair.jparams)
    assert set(state) == set(jflat)
    np.testing.assert_array_equal(state["mamba_groups.conv_w"].numpy(),
                                  np.asarray(pair.jparams["mamba_groups"]["conv_w"]))
    assert pair.model.param_count() == pair.jmodel.param_count()
    full = build(get_config("zamba2-7b"))
    assert full.param_count() == 6_751_130_832
    assert full.n_attn_sites == 14 and full._hybrid_shape() == (13, 3, 6)
    # the compute copy keeps the leaves the reference reads in float32
    bf16 = build(dataclasses.replace(pair.cfg, dtype="bfloat16")).load_params(
        state, device="cpu")
    params, layers = bf16.compute_params()
    block = layers[1][0]
    assert block["A_log"].dtype == block["dt_bias"].dtype == torch.float32
    assert block["in_proj"].dtype == params["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    assert block["in_proj"].data_ptr() == params["mamba_groups"]["in_proj"][1, 0].data_ptr()
    assert [len(group) for group in layers] == [2, 2, 1]  # two groups, the remainder


def test_cache_shapes_match_jax(pair):
    got = pair.model.cache_shapes(3, 48)
    want = pair.jmodel.cache_shapes(3, 48)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path


def test_forward_prefill_decode(pair):
    """Forward logits at a ragged S (80 over chunks of 32), then prefill
    (logits and every cache leaf) and four decode steps."""
    rng = np.random.default_rng(5)
    b, s, max_seq = 2, 80, 96
    tokens = rng.integers(2, pair.cfg.vocab_size, size=(b, s)).astype(np.int32)
    logits, aux = pair.model.forward({"tokens": torch.from_numpy(tokens)})
    jlogits, _ = pair.jforward(pair.jparams, {"tokens": jnp.asarray(tokens)})
    _close(logits, jlogits, MODEL_TOL)
    assert float(aux) == 0.0

    last, cache = pair.model.prefill({"tokens": torch.from_numpy(tokens)}, max_seq)
    jlast, jcache = pair.jprefill(pair.jparams, {"tokens": jnp.asarray(tokens)}, max_seq)
    _close(last, jlast, MODEL_TOL)

    def leaves():
        for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
            node = cache
            for k in path:
                node = node[k.key]
            yield node, leaf

    for got, want in leaves():
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, MODEL_TOL)
    for _ in range(4):
        tok = rng.integers(2, pair.cfg.vocab_size, size=(b, 1)).astype(np.int32)
        logits, cache = pair.model.decode_step(cache, {"tokens": torch.from_numpy(tok)})
        jlogits, jcache = pair.jdecode(pair.jparams, jcache, {"tokens": jnp.asarray(tok)})
        _close(logits, jlogits, MODEL_TOL)
    for got, want in leaves():
        _close(got, want, MODEL_TOL)


# ---------------------------------------------------------------------------
# Engines and the launcher
# ---------------------------------------------------------------------------

def test_serve_engine_matches_jax(pair):
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, pair.cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 12, 9)]
    engine = ServeEngine(pair.model, max_batch=4, max_seq=48, eos_id=-1, device="cpu")
    jengine = JServeEngine(pair.jmodel, pair.jparams, max_batch=4, max_seq=48, eos_id=-1)
    got = engine.generate(prompts, max_new=6)
    want = jengine.generate(prompts, max_new=6)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]


def test_continuous_engine_matches_jax(pair):
    """Five requests over two slots with ragged max_new: refills happen
    mid-stream and splice every hybrid cache leaf; each request's tokens
    equal the reference engine's."""
    rng = np.random.default_rng(7)
    lens, max_new = (5, 9, 5, 9, 5), (3, 6, 2, 5, 4)  # two prompt widths: two compiles
    prompts = [rng.integers(2, pair.cfg.vocab_size, size=n).astype(np.int32) for n in lens]
    engine = ContinuousEngine(pair.model, max_batch=2, max_seq=48, eos_id=-1, device="cpu")
    jengine = JContinuousEngine(pair.jmodel, pair.jparams, max_batch=2, max_seq=48, eos_id=-1)
    got = engine.serve([Request(p, m) for p, m in zip(prompts, max_new)])
    want = jengine.serve([JRequest(p, m) for p, m in zip(prompts, max_new)])
    assert all(r.done for r in got)
    assert [r.out for r in got] == [r.out for r in want]
    assert [len(r.out) for r in got] == list(max_new)


def test_splice_locates_the_hybrid_batch_axes(pair):
    """The batch axis of every hybrid leaf: mamba (n_full, per, B, ...),
    mamba_rest (rem, B, ...), attn (sites, B, S, K, hd) and pos (B,)."""
    model = pair.model
    big = model.init_cache(3, 16)
    one = model.init_cache(1, 16)
    for name in ("mamba", "mamba_rest", "attn"):
        one[name] = {k: t + 1 for k, t in one[name].items()}
    one["pos"] = torch.ones(1, dtype=torch.int32)
    out = _splice(big, one, 1)
    assert out is big
    for leaf, axis in ((out["mamba"]["state"], 2), (out["mamba"]["conv"], 2),
                       (out["mamba_rest"]["state"], 1), (out["attn"]["k"], 1)):
        slots = leaf.movedim(axis, 0)
        assert float(slots[0].abs().sum()) == 0 and float(slots[2].abs().sum()) == 0
        assert bool((slots[1] == 1).all())
    assert out["pos"].tolist() == [0, 1, 0]


def test_launch_serve_runs_the_hybrid_arch(capsys):
    serve_launch.main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                       "--batch", "2", "--max-new", "3"])
    assert "6 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The K6 check of chip_smoke.py and its fault tool
# ---------------------------------------------------------------------------

def _kernel_numerics(q, k, v, ld, h_in, fault=None):
    """K6's arithmetic on the bf16 inputs in float32, rounding P and y once
    each as the kernel does; ``fault`` plants one of tools/ssd_faults.py's
    faults."""
    qf, kf, vf = q.float(), k.float(), v.float()
    n = q.shape[1]
    i, j = torch.arange(n)[:, None], torch.arange(n)[None, :]
    causal = j < i if fault == "mask_off_by_one" else j <= i
    if fault == "one_key":
        causal = causal & ~((i >= 128) & (j == 128))
    cum = torch.cumsum(ld.float(), 1)
    decay = torch.exp(torch.where(causal, cum[:, :, None] - cum[:, None, :], 0.0))
    p = torch.where(causal, (qf @ kf.transpose(1, 2)) * decay, 0.0).to(torch.bfloat16).float()
    inter = (qf * torch.exp(cum)[..., None]) @ h_in
    if fault == "no_hin_late":
        inter[:, 128:] = 0
    y = (p @ vf + inter).to(torch.bfloat16)
    state = (kf * torch.exp(cum[:, -1:] - cum)[..., None]).transpose(1, 2) @ vf
    if fault != "no_state_hin":
        state = state + torch.exp(cum[:, -1])[:, None, None] * h_in
    return y, state


@pytest.mark.parametrize("fault", [None, "no_hin_late", "mask_off_by_one", "no_state_hin",
                                   "one_key"])
def test_ssd_tolerance_separates_rounding_from_faults(fault):
    # chip_smoke.py holds K6 to its plain version element by element, each
    # row at its own scale; K6's own roundings pass (the CPU emulation uses
    # ~0.3 of the limit), each planted fault lands far over it in the
    # weak-decay case, where the incoming state still reaches the late rows.
    chip_smoke = importlib.import_module("chip_smoke")
    rng = np.random.default_rng(12)
    bh, n = 16, 256
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, n, 64)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    # Mamba2's published init: softplus(dt) log-uniform in [1e-3, 0.1], A in [1, 16]
    dt0 = np.exp(rng.uniform(math.log(1e-3), math.log(0.1), size=(bh, 1)))
    bias = dt0 + np.log(-np.expm1(-dt0))
    dt = np.logaddexp(rng.normal(size=(bh, n)) + bias, 0.0)
    ld = torch.from_numpy((-dt * rng.uniform(1, 16, size=(bh, 1))).astype(np.float32))
    ld = ld.to(torch.bfloat16)
    h_in = torch.from_numpy(16 * rng.normal(size=(bh, 64, 64)).astype(np.float32))
    want = ssd_ref.ssd_chunk(q, k, v, ld, h_in)
    got = _kernel_numerics(q, k, v, ld, h_in, fault)
    share = max(chip_smoke.ssd_share(g, w, "bfloat16") for g, w in zip(got, want))
    assert (share > 1.0) == (fault is not None), share


@pytest.mark.parametrize("fault", [None, "dropped_split"])
def test_ssd_state_tolerance_separates_rounding_from_a_dropped_split(fault):
    # chip_smoke.py holds K6's states (float32 products of bf16 inputs, dte k
    # split into three bf16 terms) to the plain version on float32 copies
    # within SSD_TOL["float32"]; the exact split passes, one without its
    # middle term (a 2^-9 relative error in dte k) lands far over it.
    chip_smoke = importlib.import_module("chip_smoke")
    rng = np.random.default_rng(13)
    g, nc, l, hg = 1, 2, 256, 4
    k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
            for shape in ((g, nc, l, 64), (g, nc, l, hg, 64)))
    ld = torch.from_numpy(-np.logaddexp(rng.normal(size=(g, nc, l, hg)), 0.0)
                          .astype(np.float32)).to(torch.bfloat16)
    want = ssd_ref.ssd_chunk_states(k.float(), v.float(), ld.float())
    cum = torch.cumsum(ld.float(), 2)                                  # (G, NC, L, Hg)
    kd = k.float()[..., None, :] * torch.exp(cum[:, :, -1:] - cum)[..., None]
    hi = kd.to(torch.bfloat16).float()
    mid = (kd - hi).to(torch.bfloat16).float()
    lo = (kd - hi - mid).to(torch.bfloat16).float()
    terms = hi + lo if fault == "dropped_split" else hi + mid + lo
    got = torch.einsum("gclhd,gclhv->ghcdv", terms, v.float())
    share = chip_smoke.ssd_share(got, want, "float32")
    assert (share > 1.0) == (fault is not None), share


def test_ssd_faults_edit_the_kernel_source():
    # tools/ssd_faults.py plants each fault by a text edit of the K6 source;
    # every edit must find its text there exactly once.
    spec = importlib.util.spec_from_file_location("ssd_faults", ROOT / "tools" / "ssd_faults.py")
    faults = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(faults)
    source = (ROOT / "src" / "repro_torch" / "csrc" / "ssd_chunks.cu").read_text()
    assert set(faults.FAULTS) >= {"none", "no_hin_late", "mask_off_by_one", "no_state_hin",
                                  "one_key", "f32_mask_off_by_one", "wrong_group",
                                  "dropped_split", "states_read_hin", "below_diag_decay"}
    for name, (_, _, edits) in faults.FAULTS.items():
        assert bool(edits) == (name != "none")
        for old, _ in edits:
            assert source.count(old) == 1, name
