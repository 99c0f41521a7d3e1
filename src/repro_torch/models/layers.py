"""Shared transformer building blocks (twin of the JAX package's
``models/layers.py``): RMSNorm with the reference's hand-written
backward, RoPE, GQA attention (full / sliding / prefix-LM /
bidirectional; teacher-forced and cached decode), and the FFN variants
of the dense family.

Parameters are nested dicts of tensors with the reference's paths (see
``models.params``). Compute runs in ``cfg.dtype``; the softmax and the
norms accumulate in float32. The ``.to(dt)`` casts mirror the
reference's per-op ``astype``; on the model's compute copy of the
weights (``Model.compute_params``) they are no-ops.

Gradients take the plain paths: K5 has no backward (nor has the
reference's Pallas kernel), so its gate is shut to activations that
require grad, and its router raises if one reaches it.

On a mesh (``sh``, the mesh Model's ``sharding.activations.ActMesh``)
the activations are DTensors. The attention core runs on each rank's
local shard (``ActMesh.local``): batch rows over the batch axes, heads
over 'model' where the head count divides it (else every model rank runs
all heads, as GSPMD would), so K5 takes plain local tensors. With
context parallelism (``cp``) the chunked core splits the query chunks
over 'model' instead. Cached decode on a mesh writes the new K/V row into
the local shard of the cache and, when the cache's sequence is split over
'model' (few KV heads), combines the shards' softmax partials with two
all-reduces over 'model'.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def _rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + _RMS_EPS) * scale.to(torch.float32)
    return y.to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """The reference's ``_rmsnorm_core`` with its custom VJP: the backward
    keeps x in its own dtype (not a float32 copy) and recomputes the
    float32 statistics from it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, scale)
        return _rmsnorm_fwd(x, scale)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, scale = ctx.saved_tensors
        xf = x.to(torch.float32)
        gf = g.to(torch.float32) * scale.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        inv = torch.rsqrt(var + _RMS_EPS)
        dot = torch.mean(gf * xf, dim=-1, keepdim=True)
        dx = inv * (gf - xf * dot * inv * inv)
        # Summed over every leading dim at once (a flattening view of a
        # DTensor split on two of them costs its sharding propagation
        # minutes); on a contiguous tensor the same sum as over rows.
        dscale = torch.sum(g.to(torch.float32) * xf * inv, dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype).reshape(scale.shape)


def rmsnorm(p: Params, x: torch.Tensor) -> torch.Tensor:
    scale = p["scale"]
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale)
    return _rmsnorm_fwd(x, scale)  # no graph to build: skip the Function's overhead


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


def _project_qkv(cfg: ArchConfig, p: Params, x: torch.Tensor, positions: torch.Tensor,
                 sh=None):
    h, k = cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype

    def proj(w, bkey, n):
        y = x @ p[w].to(dt)
        if cfg.use_bias:
            y = y + p[bkey].to(dt)
        return _split_heads(sh, y, n)

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
    activations are on a CUDA card and need no gradient": plain
    causal/bidirectional full attention goes through K5
    (kernels/flash_attention) when S is a multiple of 512 and head_dim of
    128; sliding / prefix-LM masks, and activations that require grad (K5
    has no backward), stay on the plain paths."""
    if x.device.type != "cuda" or x.requires_grad:
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


def _q_chunk(s: int) -> int:
    # cap live scores at q_chunk * s <= 4M elems per (batch, head)
    return max(128, min(1024, (1 << 22) // s))


def _sdpa_chunked(q, k, v, cfg: ArchConfig, *, window, prefix_len,
                  q_chunk: int | None = None, q_off: int = 0):
    """Attention over query chunks: O(S * chunk) live logits instead of
    O(S^2). Each chunk takes the same f32 softmax over all keys as
    ``_sdpa``; under grad each chunk is a non-reentrant checkpoint (the
    reference's per-chunk ``jax.checkpoint``), so the backward recomputes
    a chunk's scores instead of storing S^2 of them.

    q may hold a contiguous run of the queries, its first at absolute
    position ``q_off``, over all S keys: a model rank's share of the
    chunks under context parallelism (``attn_apply(cp=...)``)."""
    b, sq, h, hd = q.shape
    s = k.shape[1]
    kv = k.shape[2]
    g = h // kv
    if q_chunk is None:
        q_chunk = _q_chunk(s)
    n_chunks = sq // q_chunk
    qg = q.reshape(b, n_chunks, q_chunk, kv, g, hd)

    def one_chunk(ci, qc, k, v):
        bias = _mask(cfg, q_chunk, s, q_off + ci * q_chunk, window=window,
                     prefix_len=prefix_len, device=q.device)
        logits = torch.einsum("bqkgh,bskh->bkgqs", qc, k).to(torch.float32)
        logits = logits / math.sqrt(hd) + bias
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bkgqs,bskh->bqkgh", w, v)

    grad = torch.is_grad_enabled()
    outs = [checkpoint(one_chunk, ci, qg[:, ci], k, v, use_reentrant=False) if grad
            else one_chunk(ci, qg[:, ci], k, v) for ci in range(n_chunks)]
    return torch.stack(outs, dim=1).reshape(b, sq, h, hd)


def _attend(cfg: ArchConfig, q, k, v, *, prefix_len: int, chunked: bool):
    """The attention core on plain tensors: K5 through its gate, else the
    chunked or the plain path."""
    s = q.shape[1]
    window = cfg.window if cfg.attention == "sliding" else None
    if _use_flash_kernel(cfg, s, prefix_len, q):
        from repro_torch.kernels.flash_attention import ops as flash_ops
        return flash_ops.flash_attention(q, k, v, causal=not cfg.is_encoder)
    if chunked and s % 1024 == 0 and s > 1024:
        return _sdpa_chunked(q, k, v, cfg, window=window, prefix_len=prefix_len)
    bias = _mask(cfg, s, s, 0, window=window, prefix_len=prefix_len, device=q.device)
    return _sdpa(q, k, v, bias)


def _kv_heads_of_rank(h: int, kv: int, hl: int, r: int) -> slice | None:
    """The KV heads that q heads [r hl, (r + 1) hl) read (GQA groups of
    h / kv), when they are a contiguous run that splits the local q heads
    into equal groups; else None."""
    g = h // kv
    if hl % g == 0:
        return slice(r * hl // g, (r + 1) * hl // g)
    if g % hl == 0:
        return slice(r * hl // g, r * hl // g + 1)
    return None


def _attend_on_mesh(cfg: ArchConfig, sh, q, k, v, *, prefix_len: int, chunked: bool, cp):
    """``_attend`` on each rank's local shard of the DTensors q (B,S,H,hd),
    k, v (B,S,K,hd): rows over the batch axes, q heads over 'model' when H
    divides it, KV heads too when K does (else each rank takes the KV heads
    its q heads read). With ``cp`` and the chunked path, each model rank
    takes a contiguous run of the query chunks instead, over all keys."""
    b, s, h, _ = q.shape
    kv = k.shape[2]
    be = sh.batch(b)
    window = cfg.window if cfg.attention == "sliding" else None
    n_chunks = s // _q_chunk(s)
    if (cp and chunked and s % 1024 == 0 and s > 1024 and sh.tp > 1
            and n_chunks % sh.tp == 0):
        r = sh.coord("model")
        return sh.local(
            lambda ql, kl, vl: _sdpa_chunked(ql, kl, vl, cfg, window=window,
                                             prefix_len=prefix_len, q_off=r * ql.shape[1]),
            (q, k, v), [(be, "model"), (be,), (be,)], (be, "model"))
    qh, kh = sh.heads(h), sh.heads(kv)
    kv_slice = None
    if qh and not kh:
        kv_slice = _kv_heads_of_rank(h, kv, h // sh.tp, sh.coord("model"))
        if kv_slice is None:
            qh = None

    def core(ql, kl, vl):
        if kv_slice is not None:
            kl, vl = kl[:, :, kv_slice], vl[:, :, kv_slice]
        return _attend(cfg, ql, kl, vl, prefix_len=prefix_len, chunked=chunked)

    return sh.local(core, (q, k, v), [(be, None, qh), (be, None, kh), (be, None, kh)],
                    (be, None, qh))


def _split_heads(sh, y: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd); on a mesh, a last dim split over
    more ranks than n divides is gathered first."""
    b, s, _ = y.shape
    if sh is not None and sh.heads(n) is None:
        from torch.distributed.tensor import Replicate, Shard

        if any(p == Shard(2) for p in y.placements):
            y = y.redistribute(sh.mesh, [Replicate() if p == Shard(2) else p
                                         for p in y.placements])
    return y.reshape(b, s, n, -1)


def attn_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
               prefix_len: int = 0, chunked: bool = False,
               return_kv: bool = False, sh=None, cp: bool = False):
    """Teacher-forced full-sequence attention (train / prefill). On a mesh
    (``sh``) the core runs on local shards (``_attend_on_mesh``)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(cfg, p, x, positions, sh=sh)
    if sh is None:
        out = _attend(cfg, q, k, v, prefix_len=prefix_len, chunked=chunked)
    else:
        out = _attend_on_mesh(cfg, sh, q, k, v, prefix_len=prefix_len, chunked=chunked,
                              cp=cp)
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


def _sdpa_split(q, k, v, mask_bias, groups):
    """``_sdpa`` over keys split across ranks: k, v and mask_bias hold this
    rank's positions, and ``groups`` are the (1-D) meshes whose ranks hold
    the others. Each rank takes its logits' max and exp-sum, all-reduces
    them, and all-reduces its share of the output (float32)."""
    import torch.distributed._functional_collectives as funcol

    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32)
    logits = logits / math.sqrt(hd) + mask_bias
    m = logits.amax(dim=-1, keepdim=True)
    for grp in groups:
        m = funcol.all_reduce(m, "max", grp)
    e = torch.exp(logits - m)
    denom = e.sum(dim=-1, keepdim=True)
    for grp in groups:
        denom = funcol.all_reduce(denom, "sum", grp)
    w = (e / denom).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v).to(torch.float32)
    for grp in groups:
        out = funcol.all_reduce(out, "sum", grp)
    return out.to(q.dtype).reshape(b, sq, h, hd)


def _decode_attend(cfg: ArchConfig, q, k1, v1, k, v, pos, *, s_off: int = 0,
                   s_cache: int | None = None, groups=()):
    """Write the new K/V rows (k1, v1 (B,1,K,hd)) into the cache k, v
    (B,S,K,hd) in place and attend q (B,1,H,hd) over it. On a mesh the
    cache may hold positions [s_off, s_off + S) of ``s_cache`` split over
    ``groups``: a rank writes only the rows it holds, and the softmax is
    combined across the groups (``_sdpa_split``)."""
    b = q.shape[0]
    s_loc = k.shape[1]
    s_cache = s_cache or s_loc
    slot = pos % s_cache if cfg.attention == "sliding" else pos
    # dynamic_update_slice clamps its start into range; so does the write.
    row = slot.clamp(0, s_cache - 1)
    batch_idx = torch.arange(b, device=q.device)
    if not groups:
        k[batch_idx, row] = k1[:, 0].to(k.dtype)
        v[batch_idx, row] = v1[:, 0].to(v.dtype)
    else:
        lr = row - s_off
        held = ((lr >= 0) & (lr < s_loc))[:, None, None]
        lr = lr.clamp(0, s_loc - 1)
        k[batch_idx, lr] = torch.where(held, k1[:, 0].to(k.dtype), k[batch_idx, lr])
        v[batch_idx, lr] = torch.where(held, v1[:, 0].to(v.dtype), v[batch_idx, lr])

    idx = s_off + torch.arange(s_loc, device=q.device)[None, :]           # (1, S)
    if cfg.attention == "sliding":
        # Ring buffer: slot i last written at absolute position pos - age,
        # age = (slot - i) mod W; valid iff that position exists (age<=pos).
        age = (slot[:, None] - idx) % s_cache
        valid = age <= pos[:, None]
    else:
        valid = idx <= pos[:, None]                                         # (B, S)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(valid, zero, NEG_INF)
    bias = bias[:, None, None, None, :]      # (B,1,1,1,S) over (b,k,g,q,s)
    if groups:
        return _sdpa_split(q, k.to(q.dtype), v.to(q.dtype), bias, groups)
    return _sdpa(q, k.to(q.dtype), v.to(q.dtype), bias)


def _decode_attend_on_mesh(cfg: ArchConfig, sh, q, k1, v1, k, v, pos):
    """``_decode_attend`` on local shards, laid out as the cache DTensors
    k, v are (``sharding.rules.cache_pspecs``): their batch and head
    placements are given to q, k1, v1 and pos, and a sequence split (over
    'model' for few KV heads, over 'data' too at batch 1) becomes the
    split softmax."""
    from torch.distributed.tensor import Replicate, Shard

    names = sh.mesh.mesh_dim_names
    cache_pl = list(k.placements)
    act_pl = [pl if pl in (Shard(0), Shard(2)) else Replicate() for pl in cache_pl]
    pos_pl = [pl if pl == Shard(0) else Replicate() for pl in cache_pl]
    seq = [i for i, pl in enumerate(cache_pl) if pl == Shard(1)]
    s_cache = k.shape[1]
    s_loc = k.to_local().shape[1]
    chunk = 0
    for i in seq:
        chunk = chunk * sh.mesh.size(i) + sh.coord(names[i])
    groups = tuple(sh.mesh[names[i]] for i in seq)
    return sh.local(
        lambda ql, k1l, v1l, kl, vl, pl: _decode_attend(
            cfg, ql, k1l, v1l, kl, vl, pl, s_off=chunk * s_loc, s_cache=s_cache, groups=groups),
        (q, k1, v1, k, v, pos), [act_pl, act_pl, act_pl, cache_pl, list(v.placements), pos_pl],
        act_pl)


def attn_decode(cfg: ArchConfig, p: Params, x: torch.Tensor, cache: Params,
                pos, sh=None) -> tuple[torch.Tensor, Params]:
    """One-token decode. x: (B, 1, d); pos: absolute position -- scalar
    (lockstep batch) or (B,) PER-SLOT (continuous batching). Writes the
    new K/V row into ``cache`` IN PLACE (the reference returns an updated
    copy; its engines donate the old one, so no caller sees the
    difference) and returns (y (B,1,d), cache). On a mesh (``sh``) the
    cache leaves are DTensors and each rank writes and reads its shard
    (``_decode_attend_on_mesh``)."""
    b = x.shape[0]
    if sh is None:
        pos = torch.as_tensor(pos, device=x.device).to(torch.int64).expand(b)   # (B,)
    else:
        pos = pos.to(torch.int64)
    positions = pos[:, None]                                                # (B, 1)
    q, k1, v1 = _project_qkv(cfg, p, x, positions, sh=sh)
    if sh is None:
        out = _decode_attend(cfg, q, k1, v1, cache["k"], cache["v"], pos)
    else:
        out = _decode_attend_on_mesh(cfg, sh, q, k1, v1, cache["k"], cache["v"], pos)
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

def _resid(sh, x: torch.Tensor) -> torch.Tensor:
    """The residual stream after an add: placed by ``sh.resid`` on a mesh."""
    return x if sh is None else sh.resid(x)


def block_specs(cfg: ArchConfig) -> Params:
    return {
        "ln1": rmsnorm_specs(cfg.d_model),
        "attn": attn_specs(cfg),
        "ln2": rmsnorm_specs(cfg.d_model),
        "ffn": ffn_specs(cfg),
    }


def block_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                prefix_len: int = 0, chunked: bool = False,
                return_kv: bool = False, sh=None, cp: bool = False):
    a = attn_apply(cfg, p["attn"], rmsnorm(p["ln1"], x),
                   prefix_len=prefix_len, chunked=chunked, return_kv=return_kv,
                   sh=sh, cp=cp)
    if return_kv:
        a, kv = a
    x = _resid(sh, x + a)
    x = _resid(sh, x + ffn_apply(cfg, p["ffn"], rmsnorm(p["ln2"], x)))
    if return_kv:
        return x, kv
    return x


def block_decode(cfg: ArchConfig, p: Params, x: torch.Tensor, cache: Params,
                 pos, sh=None) -> tuple[torch.Tensor, Params]:
    a, new_cache = attn_decode(cfg, p["attn"], rmsnorm(p["ln1"], x), cache, pos, sh=sh)
    x = _resid(sh, x + a)
    x = _resid(sh, x + ffn_apply(cfg, p["ffn"], rmsnorm(p["ln2"], x)))
    return x, new_cache
