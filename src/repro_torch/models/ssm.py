"""Mamba2 block (SSD) (twin of the JAX package's ``models/ssm.py``).

Structure follows arXiv:2405.21060 (single B/C group):

    u -> in_proj -> [z (d_ssm) | x (d_ssm) | B (N) | C (N) | dt (H)]
    x,B,C -> causal depthwise conv (width ssm_conv) -> silu
    dt = softplus(dt + dt_bias); a = -exp(A_log)  (per head)
    h_t = exp(dt a) h_{t-1} + dt * B x^T ;  y = C . h + D * x
    out = out_proj( rmsnorm(y * silu(z)) )

Decode carries ``{"conv": (B, ssm_conv-1, conv_dim), "state": (B,H,N,P)}``.
A prefill's conv tail is its last ``ssm_conv - 1`` positions, so a prompt
shorter than that leaves a cache that does not fit (the reference's too):
prompts have at least ``ssm_conv - 1`` tokens.

``dt_bias`` and ``A_log`` are read in float32, as the reference reads its
float32 masters (``Model.compute_params`` keeps them so).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import params as pr
from repro_torch.models import scan_core
from repro_torch.models.layers import rmsnorm, rmsnorm_specs

Params = dict[str, Any]


def _dims(cfg: ArchConfig):
    d_ssm = cfg.d_ssm
    n_heads = cfg.n_ssm_heads
    n = cfg.ssm_state
    conv_dim = d_ssm + 2 * n
    return d_ssm, n_heads, n, conv_dim


def mamba2_specs(cfg: ArchConfig) -> Params:
    d_ssm, h, n, conv_dim = _dims(cfg)
    d_in = 2 * d_ssm + 2 * n + h
    return {
        "ln": rmsnorm_specs(cfg.d_model),
        "in_proj": pr.dense(cfg.d_model, d_in),
        "conv_w": pr.ParamSpec((cfg.ssm_conv, conv_dim), "small"),
        "conv_b": pr.bias(conv_dim),
        "A_log": pr.ParamSpec((h,), "small"),
        "dt_bias": pr.bias(h),
        "D": pr.norm_scale(h),
        "out_norm": rmsnorm_specs(d_ssm),
        "out_proj": pr.dense(d_ssm, cfg.d_model),
    }


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    d_ssm, h, n, _ = _dims(cfg)
    z, x, bmat, cmat, dt = torch.split(proj, [d_ssm, d_ssm, n, n, h], dim=-1)
    return z, x, bmat, cmat, dt


def _conv_full(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, S, C) with taps (W, C)."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros_like(xbc)
    for t in range(width):  # width is 4: unrolled FMA
        out = out + pad[:, t : t + xbc.shape[1], :] * w[t].to(xbc.dtype)
    return out + b.to(xbc.dtype)


def _use_ssd_kernel(x: torch.Tensor, initial_state, s: int, chunk: int) -> bool:
    """The reference's gate, with "the backend is a TPU" read as "the
    activations are on a CUDA card and need no gradient": with no initial
    state and S a multiple of the chunk, the chunk step runs as K6
    (kernels/ssd), at every config's SSD state and head sizes (full and
    reduced), as the reference's Pallas kernel does. K6 has no backward
    (nor has the reference's Pallas kernel), so activations that require
    grad take ``scan_core``."""
    return (x.device.type == "cuda" and not x.requires_grad and initial_state is None
            and s % chunk == 0)


def _ssm_inner(cfg: ArchConfig, p: Params, x, bmat, cmat, dt_raw, *, initial_state=None):
    """Shared by full-seq; returns (y (B,S,d_ssm), final_state).

    Through the gate the chunk step runs as K6 on the model's layout (B and
    C once per batch row, v and y as (B, S, H, P)) with the log-decay
    rounded to the activations' type (the reference's cast); otherwise the
    plain chunked core with float32 log-decay."""
    n = cfg.ssm_state
    b_, s, d_x = x.shape
    pdim = cfg.ssm_head_dim
    h = d_x // pdim  # the heads x holds (a model rank's share on a mesh)
    xh = x.reshape(b_, s, h, pdim)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])         # (B,S,H)
    a = -torch.exp(p["A_log"].to(torch.float32))                     # (H,)
    log_decay = dt * a                                               # (B,S,H)
    v = xh * dt[..., None].to(x.dtype)
    chunk = min(cfg.ssm_chunk, s)
    if _use_ssd_kernel(x, initial_state, s, chunk):
        from repro_torch.kernels.ssd import ops as ssd_ops

        y, state = ssd_ops.ssd_scan_grouped(cmat.to(x.dtype), bmat.to(x.dtype), v,
                                            log_decay.to(x.dtype), chunk=chunk)
    else:
        k = bmat[:, :, None, :].expand(b_, s, h, n).to(x.dtype)
        q = cmat[:, :, None, :].expand(b_, s, h, n).to(x.dtype)
        y, state = scan_core.chunked_linear_attention(
            q, k, v, log_decay, chunk=chunk, initial_state=initial_state)
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    return y.reshape(b_, s, d_x), state


def _ssm_inner_on_mesh(cfg: ArchConfig, sh, p: Params, x, bmat, cmat, dt_raw):
    """``_ssm_inner`` on each rank's local shard: rows over the batch axes,
    SSD heads over 'model' where their count divides it (x, dt and the
    per-head parameters split alike; B and C whole), so K6 takes plain
    local tensors. Returns DTensors y (B,S,d_ssm) and state (B,H,N,P)."""
    be, hh = sh.batch(x.shape[0]), sh.heads(cfg.n_ssm_heads)

    def inner(xl, bl, cl, dl, a_log, dt_bias, d_skip):
        return _ssm_inner(cfg, {"A_log": a_log, "dt_bias": dt_bias, "D": d_skip},
                          xl, bl, cl, dl)

    return sh.local(inner, (x, bmat, cmat, dt_raw, p["A_log"], p["dt_bias"], p["D"]),
                    [(be, None, hh), (be,), (be,), (be, None, hh), (hh,), (hh,), (hh,)],
                    ((be, None, hh), (be, hh)))


def mamba2_apply(cfg: ArchConfig, p: Params, u: torch.Tensor, return_cache: bool = False,
                 sh=None):
    """Full-sequence residual block. u: (B, S, d_model).

    With ``return_cache`` also returns the decode cache after the last
    position (prefill): conv tail + final SSM state. On a mesh (``sh``)
    the SSD core runs on local shards (``_ssm_inner_on_mesh``)."""
    dt = u.dtype
    xin = rmsnorm(p["ln"], u)
    proj = xin @ p["in_proj"].to(dt)
    z, x, bmat, cmat, dtr = _split_proj(cfg, proj)
    xbc_raw = torch.cat([x, bmat, cmat], dim=-1)
    xbc = F.silu(_conv_full(xbc_raw, p["conv_w"], p["conv_b"]))
    d_ssm, _, n, _ = _dims(cfg)
    x, bmat, cmat = torch.split(xbc, [d_ssm, n, n], dim=-1)
    if sh is None:
        y, state = _ssm_inner(cfg, p, x, bmat, cmat, dtr)
    else:
        y, state = _ssm_inner_on_mesh(cfg, sh, p, x, bmat, cmat, dtr)
    y = rmsnorm(p["out_norm"], y * F.silu(z))
    out = u + y @ p["out_proj"].to(dt)
    if sh is not None:
        out = sh.resid(out)
    if not return_cache:
        return out
    # A copy, so that a prefill's cache does not hold every block's xbc_raw.
    cache = {"conv": xbc_raw[:, -(cfg.ssm_conv - 1):, :].clone(), "state": state}
    return out, cache


# --- cached decode -----------------------------------------------------------

def mamba2_cache_shape(cfg: ArchConfig, batch: int):
    d_ssm, h, n, conv_dim = _dims(cfg)
    return {
        "conv": (batch, cfg.ssm_conv - 1, conv_dim),
        "state": (batch, h, n, cfg.ssm_head_dim),
    }


def mamba2_decode(cfg: ArchConfig, p: Params, u: torch.Tensor, cache: Params
                  ) -> tuple[torch.Tensor, Params]:
    """u: (B, 1, d_model). Returns (out, new cache); ``cache`` is read,
    not written."""
    dt_ = u.dtype
    d_ssm, h, n, conv_dim = _dims(cfg)
    pdim = cfg.ssm_head_dim
    xin = rmsnorm(p["ln"], u)
    proj = (xin @ p["in_proj"].to(dt_))[:, 0]            # (B, d_in)
    z, x, bmat, cmat, dtr = _split_proj(cfg, proj)
    xbc = torch.cat([x, bmat, cmat], dim=-1)              # (B, conv_dim)
    hist = torch.cat([cache["conv"].to(dt_), xbc[:, None, :]], dim=1)  # (B, W, conv_dim)
    # The width-W dot of the reference's einsum, accumulated in float32.
    conv_out = (hist.to(torch.float32) * p["conv_w"].to(dt_).to(torch.float32)).sum(1).to(dt_)
    xbc = F.silu(conv_out + p["conv_b"].to(dt_))
    x, bmat, cmat = torch.split(xbc, [d_ssm, n, n], dim=-1)

    dtv = F.softplus(dtr.to(torch.float32) + p["dt_bias"])         # (B,H)
    a = -torch.exp(p["A_log"].to(torch.float32))
    log_decay = dtv * a
    xh = x.reshape(-1, h, pdim)
    k = bmat[:, None, :].expand(x.shape[0], h, n).to(dt_)
    q = cmat[:, None, :].expand(x.shape[0], h, n).to(dt_)
    v = xh * dtv[..., None].to(dt_)
    y, state = scan_core.linear_attention_step(q, k, v, log_decay, cache["state"])
    y = y + xh * p["D"].to(dt_)[None, :, None]
    y = y.reshape(-1, 1, d_ssm)
    y = rmsnorm(p["out_norm"], y * F.silu(z[:, None, :]))
    out = u + y @ p["out_proj"].to(dt_)
    return out, {"conv": hist[:, 1:, :].to(cache["conv"].dtype), "state": state}
