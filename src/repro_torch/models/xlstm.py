"""xLSTM blocks (arXiv:2405.04517) (twin of the JAX package's
``models/xlstm.py``): mLSTM (matrix memory, chunked-parallel through
``models.scan_core``) and sLSTM (scalar memory, a strictly sequential
recurrence with per-head recurrent weights, ``scan_core.scan`` over time
where the reference runs ``lax.scan``: a loop a time step when it runs,
one step weighted by its trips when the dry run counts it).

The reference's numerics simplification: instead of the paper's
max-stabilizer ``m_t`` the exponential input gate is clipped to [-10, 5]
and the mLSTM output stabilized by ``max(|q . n|, 1)``; the sLSTM forget
gate is a sigmoid.

mLSTM calls ``scan_core`` directly and never reaches K6. sLSTM's
recurrent term is float32 (its state is float32 and the reference
promotes the bf16 recurrent weights to it), and so are its gate sums.
Its input projections ``x_t @ w`` do not depend on the state, so
``slstm_apply`` makes them for the whole sequence before the scan; each
is the per-step product of the reference up to the summation order of
one matmul (``tests/test_torch_families.py`` holds the prefill against
the per-step decode).

``out_norm`` is read in float32 (the reference multiplies its float32
master), as ``Model.compute_params`` keeps it.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import params as pr
from repro_torch.models import scan_core
from repro_torch.models.layers import _gelu, rmsnorm, rmsnorm_specs
from repro_torch.models.ssm import _conv_full

Params = dict[str, Any]

_ICLIP = (-10.0, 5.0)


def _headnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm. x: (..., H, P); scale: (H*P,)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y.reshape(*x.shape[:-2], -1) * scale).to(x.dtype).reshape(x.shape)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ArchConfig) -> Params:
    d, d_ssm, h = cfg.d_model, cfg.d_ssm, cfg.n_heads
    return {
        "ln": rmsnorm_specs(d),
        "up_proj": pr.dense(d, 2 * d_ssm),        # [x | z]
        "conv_w": pr.ParamSpec((cfg.ssm_conv, d_ssm), "small"),
        "conv_b": pr.bias(d_ssm),
        "wq": pr.dense(d_ssm, d_ssm),
        "wk": pr.dense(d_ssm, d_ssm),
        "wv": pr.dense(d_ssm, d_ssm),
        "w_igate": pr.dense(d_ssm, h),
        "w_fgate": pr.dense(d_ssm, h),
        "out_norm": pr.norm_scale(d_ssm),
        "down_proj": pr.dense(d_ssm, d),
    }


def _mlstm_qkv(cfg: ArchConfig, p: Params, xc: torch.Tensor, xr: torch.Tensor):
    """xc: conv'd branch (..., d_ssm); xr: raw branch."""
    h = cfg.n_heads
    pdim = cfg.d_ssm // h
    dt = xc.dtype

    def heads(t):
        return t.reshape(*t.shape[:-1], h, pdim)

    # The reference divides by sqrt(pdim) rounded to the compute type.
    root = float(torch.tensor(math.sqrt(pdim), dtype=torch.float32).to(dt))
    q = heads(xc @ p["wq"].to(dt)) / root
    k = heads(xc @ p["wk"].to(dt))
    v = heads(xr @ p["wv"].to(dt))
    igate = torch.clamp((xc @ p["w_igate"].to(dt)).to(torch.float32), *_ICLIP)
    fgate = (xc @ p["w_fgate"].to(dt)).to(torch.float32)
    log_f = F.logsigmoid(fgate)                    # (..., H)
    return q, k, v, torch.exp(igate), log_f


def _stabilized(y_aug: torch.Tensor, pdim: int) -> torch.Tensor:
    yv, den = y_aug[..., :pdim], y_aug[..., pdim]
    den = torch.clamp(torch.abs(den.to(torch.float32)), min=1.0)
    return (yv.to(torch.float32) / den[..., None]).to(y_aug.dtype)


def _v_aug(v: torch.Tensor, i_scale: torch.Tensor) -> torch.Tensor:
    """[v | 1] scaled by the input gate: its last column carries the
    normalizer state n."""
    ones = torch.ones((*v.shape[:-1], 1), dtype=v.dtype, device=v.device)
    return torch.cat([v, ones], dim=-1) * i_scale[..., None].to(v.dtype)


def mlstm_apply(cfg: ArchConfig, p: Params, u: torch.Tensor, return_cache: bool = False):
    """Full-sequence residual mLSTM block. u: (B, S, d_model). With
    ``return_cache`` also the decode cache after the last position: the
    conv tail (the last ``ssm_conv - 1`` positions, so prompts have at
    least that many tokens) and the float32 state (B, H, P, P + 1)."""
    b, s, _ = u.shape
    h = cfg.n_heads
    pdim = cfg.d_ssm // h
    dt = u.dtype
    xin = rmsnorm(p["ln"], u)
    x, z = torch.chunk(xin @ p["up_proj"].to(dt), 2, dim=-1)
    xc = F.silu(_conv_full(x, p["conv_w"], p["conv_b"]))
    q, k, v, i_scale, log_f = _mlstm_qkv(cfg, p, xc, x)
    y_aug, state = scan_core.chunked_linear_attention(
        q, k, _v_aug(v, i_scale), log_f, chunk=min(cfg.ssm_chunk, s))
    y = _stabilized(y_aug, pdim)                                  # (B, S, H, P)
    y = _headnorm(p["out_norm"], y).reshape(b, s, -1)
    y = y * F.silu(z)
    out = u + y @ p["down_proj"].to(dt)
    if not return_cache:
        return out
    # A copy, so that a prefill's cache does not hold every block's x.
    return out, {"conv": x[:, -(cfg.ssm_conv - 1):, :].clone(), "state": state}


def mlstm_cache_shape(cfg: ArchConfig, batch: int):
    h = cfg.n_heads
    pdim = cfg.d_ssm // h
    return {
        "conv": (batch, cfg.ssm_conv - 1, cfg.d_ssm),
        "state": (batch, h, pdim, pdim + 1),
    }


def mlstm_decode(cfg: ArchConfig, p: Params, u: torch.Tensor, cache: Params
                 ) -> tuple[torch.Tensor, Params]:
    """u: (B, 1, d_model). Returns (out, new cache); ``cache`` is read,
    not written."""
    b = u.shape[0]
    dt = u.dtype
    pdim = cfg.d_ssm // cfg.n_heads
    xin = rmsnorm(p["ln"], u)
    x, z = torch.chunk((xin @ p["up_proj"].to(dt))[:, 0], 2, dim=-1)
    hist = torch.cat([cache["conv"].to(dt), x[:, None, :]], dim=1)   # (B, W, d_ssm)
    # The width-W dot of the reference's einsum, accumulated in float32.
    conv = (hist.to(torch.float32) * p["conv_w"].to(dt).to(torch.float32)).sum(1).to(dt)
    xc = F.silu(conv + p["conv_b"].to(dt))
    q, k, v, i_scale, log_f = _mlstm_qkv(cfg, p, xc, x)
    y_aug, state = scan_core.linear_attention_step(
        q, k, _v_aug(v, i_scale), log_f, cache["state"])
    y = _stabilized(y_aug, pdim)
    y = _headnorm(p["out_norm"], y).reshape(b, 1, -1)
    y = y * F.silu(z[:, None, :])
    out = u + y @ p["down_proj"].to(dt)
    return out, {"conv": hist[:, 1:, :].to(cache["conv"].dtype), "state": state}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

_GATES = ("zgate", "igate", "fgate", "ogate")


def slstm_specs(cfg: ArchConfig) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    pdim = d // h
    gate = {"w": pr.dense(d, d), "r": pr.dense(pdim, pdim, h), "b": pr.bias(d)}
    ff = max(64, (4 * d // 3) // 64 * 64)
    return {
        "ln": rmsnorm_specs(d),
        "zgate": dict(gate), "igate": dict(gate),
        "fgate": dict(gate), "ogate": dict(gate),
        "out_norm": pr.norm_scale(d),
        "out_proj": pr.dense(d, d),
        "ffn_ln": rmsnorm_specs(d),
        "ffn_wi": pr.dense(d, ff),
        "ffn_wo": pr.dense(ff, d),
    }


def _slstm_inputs(cfg: ArchConfig, p: Params, xin: torch.Tensor) -> list[torch.Tensor]:
    """Each gate's input projection x @ w of xin (..., d) as (..., H, P),
    in the compute type."""
    h = cfg.n_heads
    dt = xin.dtype
    return [(xin @ p[g]["w"].to(dt)).reshape(*xin.shape[:-1], h, -1) for g in _GATES]


def _slstm_step(cfg: ArchConfig, p: Params, wx: list[torch.Tensor], c, n, h_prev):
    """wx: the four gates' input projections at one step (B, H, P);
    c, n, h_prev: (B, H, P) float32. Returns (c, n, h) float32."""
    dt = wx[0].dtype

    def gate(g, wx_g):
        gp = p[g]
        # h_prev is float32 and r is cast to the compute type: the
        # reference's einsum promotes r back to float32, and the sums too.
        rh = torch.einsum("bhp,hpq->bhq", h_prev, gp["r"].to(dt).to(torch.float32))
        return wx_g + rh + gp["b"].to(dt).reshape(wx_g.shape[-2:])

    z_r, i_r, f_r, o_r = (gate(g, wx_g) for g, wx_g in zip(_GATES, wx))
    zf = torch.tanh(z_r.to(torch.float32))
    i = torch.exp(torch.clamp(i_r.to(torch.float32), *_ICLIP))
    f = torch.sigmoid(f_r.to(torch.float32))
    o = torch.sigmoid(o_r.to(torch.float32))
    c_new = f * c + i * zf
    n_new = f * n + i
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new


def _slstm_out(p: Params, u: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    """The block's output from the residual u (B, S, d) and the hidden
    states hs (B, S, H, P) in the compute type: the head norm, the output
    projection, then the post up/down FFN (xLSTM proj factor 4/3)."""
    b, s, d = u.shape
    dt = u.dtype
    y = _headnorm(p["out_norm"], hs).reshape(b, s, d)
    u = u + y @ p["out_proj"].to(dt)
    f = _gelu(rmsnorm(p["ffn_ln"], u) @ p["ffn_wi"].to(dt))
    return u + f @ p["ffn_wo"].to(dt)


def slstm_apply(cfg: ArchConfig, p: Params, u: torch.Tensor, return_cache: bool = False):
    """Full-sequence residual sLSTM block (sequential loop over time)."""
    b, s, d = u.shape
    h = cfg.n_heads
    pdim = d // h
    dt = u.dtype
    wx = _slstm_inputs(cfg, p, rmsnorm(p["ln"], u))               # 4 x (B, S, H, P)

    def step(carry, wx_t):
        c, n, hn = _slstm_step(cfg, p, wx_t, *carry)
        return (c, n, hn), hn.to(dt)

    zeros = torch.zeros((b, h, pdim), dtype=torch.float32, device=u.device)
    (c, n, hn), hs = scan_core.scan(step, (zeros, zeros, zeros), wx, dim=1)
    out = _slstm_out(p, u, hs)
    if not return_cache:
        return out
    return out, {"c": c, "n": n, "h": hn}


def slstm_cache_shape(cfg: ArchConfig, batch: int):
    h = cfg.n_heads
    pdim = cfg.d_model // h
    st = (batch, h, pdim)
    return {"c": st, "n": st, "h": st}


def slstm_decode(cfg: ArchConfig, p: Params, u: torch.Tensor, cache: Params
                 ) -> tuple[torch.Tensor, Params]:
    """u: (B, 1, d_model). Returns (out, new cache); ``cache`` is read,
    not written."""
    wx = _slstm_inputs(cfg, p, rmsnorm(p["ln"], u)[:, 0])
    c, n, hn = _slstm_step(cfg, p, wx, cache["c"], cache["n"], cache["h"])
    out = _slstm_out(p, u, hn.to(u.dtype)[:, None])
    return out, {"c": c, "n": n, "h": hn}
