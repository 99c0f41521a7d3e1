"""Shared transformer building blocks, forward only (twin of the JAX
package's ``models/layers.py``): RMSNorm, RoPE, GQA attention (full /
sliding / prefix-LM / bidirectional; teacher-forced and cached decode),
and the FFN variants of the dense family.

Parameters are nested dicts of tensors with the reference's paths (see
``models.params``). Compute runs in ``cfg.dtype``; the softmax and the
norms accumulate in float32. The ``.to(dt)`` casts mirror the
reference's per-op ``astype``; on the model's compute copy of the
weights (``Model.compute_params``) they are no-ops.

Not here yet: the custom VJP of ``rmsnorm`` and the context-parallel
form of ``_sdpa_chunked`` (training and the mesh, ROADMAP item 14).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import params as pr

Params = dict[str, Any]

NEG_INF = -1e30


def cdtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_specs(d: int) -> Params:
    return {"scale": pr.norm_scale(d)}


_RMS_EPS = 1e-6


def rmsnorm(p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + _RMS_EPS) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integer."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1f, x2f = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attn_specs(cfg: ArchConfig) -> Params:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p: Params = {
        "wq": pr.dense(d, h * hd),
        "wk": pr.dense(d, k * hd),
        "wv": pr.dense(d, k * hd),
        "wo": pr.dense(h * hd, d),
    }
    if cfg.use_bias:
        p |= {"bq": pr.bias(h * hd), "bk": pr.bias(k * hd),
              "bv": pr.bias(k * hd), "bo": pr.bias(d)}
    if cfg.qk_norm:
        p |= {"q_norm": rmsnorm_specs(hd), "k_norm": rmsnorm_specs(hd)}
    return p


def _project_qkv(cfg: ArchConfig, p: Params, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype

    def proj(w, bkey, n):
        y = x @ p[w].to(dt)
        if cfg.use_bias:
            y = y + p[bkey].to(dt)
        return y.reshape(b, s, n, hd)

    q = proj("wq", "bq", h)
    kk = proj("wk", "bk", k)
    v = proj("wv", "bv", k)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        kk = rmsnorm(p["k_norm"], kk)
    if not cfg.is_encoder:  # encoders here use absolute conv-pos (stubbed)
        q = rope(q, positions, cfg.rope_theta)
        kk = rope(kk, positions, cfg.rope_theta)
    return q, kk, v


def _use_flash_kernel(cfg: ArchConfig, s: int, prefix_len: int, x: torch.Tensor) -> bool:
    """The reference's gate, with "the backend is a TPU" read as "the
    activations are on a CUDA card": plain causal/bidirectional full
    attention goes through K5 (kernels/flash_attention) when S is a
    multiple of 512 and head_dim of 128; sliding / prefix-LM masks stay
    on the plain paths."""
    if x.device.type != "cuda":
        return False
    if cfg.attention == "sliding" or prefix_len > 0:
        return False
    return s % 512 == 0 and cfg.head_dim % 128 == 0


def _mask(cfg: ArchConfig, sq: int, skv: int, q_off: int, *, window: int | None,
          prefix_len: int = 0, device: torch.device | None = None) -> torch.Tensor:
    """(sq, skv) additive mask in f32. q_off = absolute pos of query row 0."""
    qi = q_off + torch.arange(sq, device=device)[:, None]
    kj = torch.arange(skv, device=device)[None, :]
    if cfg.is_encoder:
        allowed = torch.ones((sq, skv), dtype=torch.bool, device=device)
    else:
        allowed = kj <= qi
        if prefix_len > 0:  # prefix-LM: bidirectional over the prefix
            allowed = allowed | (kj < prefix_len)
        if window is not None:
            allowed = allowed & (kj > qi - window)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(allowed, zero, NEG_INF)


def _sdpa(q, k, v, mask_bias):
    """q: (B,Sq,H,hd), k/v: (B,Skv,K,hd); GQA grouped; f32 softmax."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32)
    logits = logits / math.sqrt(hd) + mask_bias  # broadcast (Sq,Skv)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(b, sq, h, hd)


def _sdpa_chunked(q, k, v, cfg: ArchConfig, *, window, prefix_len,
                  q_chunk: int | None = None):
    """Attention over query chunks: O(S * chunk) live logits instead of
    O(S^2). Each chunk takes the same f32 softmax over all keys as
    ``_sdpa`` (the reference's ``jax.checkpoint`` only matters for
    gradients; its context-parallel form waits with the mesh)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    if q_chunk is None:
        # cap live scores at q_chunk * s <= 4M elems per (batch, head)
        q_chunk = max(128, min(1024, (1 << 22) // s))
    n_chunks = s // q_chunk
    qg = q.reshape(b, n_chunks, q_chunk, kv, g, hd)
    outs = []
    for ci in range(n_chunks):
        bias = _mask(cfg, q_chunk, s, ci * q_chunk, window=window,
                     prefix_len=prefix_len, device=q.device)
        logits = torch.einsum("bqkgh,bskh->bkgqs", qg[:, ci], k).to(torch.float32)
        logits = logits / math.sqrt(hd) + bias
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh", w, v))
    return torch.stack(outs, dim=1).reshape(b, s, h, hd)


def attn_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
               prefix_len: int = 0, chunked: bool = False,
               return_kv: bool = False):
    """Teacher-forced full-sequence attention (prefill)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(cfg, p, x, positions)
    window = cfg.window if cfg.attention == "sliding" else None
    if _use_flash_kernel(cfg, s, prefix_len, x):
        from repro_torch.kernels.flash_attention import ops as flash_ops
        out = flash_ops.flash_attention(q, k, v, causal=not cfg.is_encoder)
    elif chunked and s % 1024 == 0 and s > 1024:
        out = _sdpa_chunked(q, k, v, cfg, window=window, prefix_len=prefix_len)
    else:
        bias = _mask(cfg, s, s, 0, window=window, prefix_len=prefix_len,
                     device=x.device)
        out = _sdpa(q, k, v, bias)
    y = out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"].to(x.dtype)
    if cfg.use_bias:
        y = y + p["bo"].to(x.dtype)
    if return_kv:
        return y, (k, v)
    return y


# --- cached decode ----------------------------------------------------------

def attn_cache_shape(cfg: ArchConfig, batch: int, max_seq: int):
    """KV cache (k, v): (B, S_cache, K, hd). Sliding attention keeps a ring
    buffer of ``window`` entries."""
    s_cache = min(max_seq, cfg.window) if cfg.attention == "sliding" else max_seq
    kv = (batch, s_cache, cfg.n_kv_heads, cfg.head_dim)
    return {"k": kv, "v": kv}


def attn_decode(cfg: ArchConfig, p: Params, x: torch.Tensor, cache: Params,
                pos) -> tuple[torch.Tensor, Params]:
    """One-token decode. x: (B, 1, d); pos: absolute position -- scalar
    (lockstep batch) or (B,) PER-SLOT (continuous batching). Writes the
    new K/V row into ``cache`` IN PLACE (the reference returns an updated
    copy; its engines donate the old one, so no caller sees the
    difference) and returns (y (B,1,d), cache)."""
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64).expand(b)   # (B,)
    positions = pos[:, None]                                                # (B, 1)
    q, k1, v1 = _project_qkv(cfg, p, x, positions)
    k, v = cache["k"], cache["v"]
    s_cache = k.shape[1]
    slot = pos % s_cache if cfg.attention == "sliding" else pos
    # dynamic_update_slice clamps its start into range; so does the write.
    row = slot.clamp(0, s_cache - 1)
    batch_idx = torch.arange(b, device=x.device)
    k[batch_idx, row] = k1[:, 0].to(k.dtype)
    v[batch_idx, row] = v1[:, 0].to(v.dtype)

    idx = torch.arange(s_cache, device=x.device)[None, :]                  # (1, S)
    if cfg.attention == "sliding":
        # Ring buffer: slot i last written at absolute position pos - age,
        # age = (slot - i) mod W; valid iff that position exists (age<=pos).
        age = (slot[:, None] - idx) % s_cache
        valid = age <= pos[:, None]
    else:
        valid = idx <= pos[:, None]                                         # (B, S)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    bias = torch.where(valid, zero, NEG_INF)
    bias = bias[:, None, None, None, :]      # (B,1,1,1,S) over (b,k,g,q,s)
    out = _sdpa(q, k.to(q.dtype), v.to(q.dtype), bias)
    y = out.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["wo"].to(x.dtype)
    if cfg.use_bias:
        y = y + p["bo"].to(x.dtype)
    return y, cache


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------

def ffn_specs(cfg: ArchConfig, d_ff: int | None = None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.ffn_act in ("swiglu", "geglu"):
        p = {"wi_gate": pr.dense(d, f), "wi_up": pr.dense(d, f),
             "wo": pr.dense(f, d)}
    else:  # gelu
        p = {"wi": pr.dense(d, f), "wo": pr.dense(f, d)}
    if cfg.use_bias:
        p |= {"bi": pr.bias(f), "bo": pr.bias(d)}
    return p


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def ffn_apply(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.ffn_act in ("swiglu", "geglu"):
        act = F.silu if cfg.ffn_act == "swiglu" else _gelu
        g = x @ p["wi_gate"].to(dt)
        u = x @ p["wi_up"].to(dt)
        if cfg.use_bias:
            g = g + p["bi"].to(dt)
        h = act(g) * u
    else:
        h = x @ p["wi"].to(dt)
        if cfg.use_bias:
            h = h + p["bi"].to(dt)
        h = _gelu(h)
    y = h @ p["wo"].to(dt)
    if cfg.use_bias:
        y = y + p["bo"].to(dt)
    return y


# ---------------------------------------------------------------------------
# Standard pre-norm transformer block (attention + ffn)
# ---------------------------------------------------------------------------

def block_specs(cfg: ArchConfig) -> Params:
    return {
        "ln1": rmsnorm_specs(cfg.d_model),
        "attn": attn_specs(cfg),
        "ln2": rmsnorm_specs(cfg.d_model),
        "ffn": ffn_specs(cfg),
    }


def block_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                prefix_len: int = 0, chunked: bool = False,
                return_kv: bool = False):
    a = attn_apply(cfg, p["attn"], rmsnorm(p["ln1"], x),
                   prefix_len=prefix_len, chunked=chunked, return_kv=return_kv)
    if return_kv:
        a, kv = a
    x = x + a
    x = x + ffn_apply(cfg, p["ffn"], rmsnorm(p["ln2"], x))
    if return_kv:
        return x, kv
    return x


def block_decode(cfg: ArchConfig, p: Params, x: torch.Tensor, cache: Params,
                 pos) -> tuple[torch.Tensor, Params]:
    a, new_cache = attn_decode(cfg, p["attn"], rmsnorm(p["ln1"], x), cache, pos)
    x = x + a
    x = x + ffn_apply(cfg, p["ffn"], rmsnorm(p["ln2"], x))
    return x, new_cache
