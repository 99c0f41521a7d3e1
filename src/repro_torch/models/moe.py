"""Token-choice top-k MoE with sort-based dispatch (twin of the JAX
package's ``models/moe.py``).

Each *group* (one sequence) permutes its token-choices by expert id with
a stable sort, gathers the first C slots per expert into (E, C, d)
buffers, runs the expert FFNs as batched einsums, and gathers the results
back per token. Overflowing choices are dropped (capacity factor; the
token-choice semantics of qwen3/phi3.5).

Two orders decide which choices are kept and must be the reference's:
the router's top-k (``top_k``: descending, ties to the lower expert
index, as ``jax.lax.top_k``) and the dispatch sort (stable, as
``jnp.argsort``). The groups are a batch axis here (the reference's
``vmap``).

Not here: the reference's hand-written expert-FFN VJP, which exists only
to constrain the weight gradients' sharding on a mesh (``build(moe_wg=
True)`` raises, ROADMAP.md queue 1, "Mesh and dry-run tools"). Without it
the reference differentiates the plain einsums, and so does autograd
here.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as ly
from repro_torch.models import params as pr

Params = dict[str, Any]


def moe_specs(cfg: ArchConfig) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": pr.dense(d, e),
        "wi_gate": pr.dense(d, f, e),   # (E, d, f)
        "wi_up": pr.dense(d, f, e),
        "wo": pr.dense(f, d, e),        # (E, f, d)
    }


def capacity(cfg: ArchConfig, group_tokens: int) -> int:
    c = math.ceil(group_tokens * cfg.experts_per_token * cfg.capacity_factor
                  / cfg.n_experts)
    return max(c, 1)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, in
    ``jax.lax.top_k``'s order: descending, equal values by increasing
    index. ``torch.topk`` promises no order among equal values (on [0.1,
    0.3, 0.3, 0.2, 0.3, 0.05] with k = 2 it gives experts 2 and 4 where
    the reference gives 1 and 2), and equal router probabilities are common
    in bf16, so this is a stable descending sort and its first k."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _dispatch_indices(idx: torch.Tensor, n_experts: int, cap: int):
    """idx: (..., G, k) expert choices of groups of G tokens.

    Returns (buf_tc (..., E, C) token-choice ids, buf_valid (..., E, C),
    slot (..., G*k) per-choice slot, kept (..., G*k)), each group's as the
    reference's: choices ordered by expert with a stable sort (so within an
    expert by token, then by rank), the first C of each expert kept."""
    *lead, g, k = idx.shape
    gk = g * k
    dev = idx.device
    e_flat = idx.reshape(*lead, gk).long()
    order = torch.argsort(e_flat, dim=-1, stable=True)           # token-choices by expert
    counts = torch.zeros((*lead, n_experts), dtype=torch.long, device=dev)
    counts.scatter_add_(-1, e_flat, torch.ones_like(e_flat))
    seg_start = torch.cumsum(counts, dim=-1) - counts            # (..., E)
    ranks = torch.arange(gk, device=dev).expand_as(order)
    inv = torch.empty_like(order).scatter_(-1, order, ranks)     # rank in sorted order
    slot = inv - torch.gather(seg_start, -1, e_flat)             # position within expert
    kept = slot < cap
    slot_idx = seg_start[..., :, None] + torch.arange(cap, device=dev)  # (..., E, C)
    buf_tc = torch.gather(order, -1, slot_idx.clamp(0, gk - 1).reshape(*lead, -1))
    buf_tc = buf_tc.reshape(*lead, n_experts, cap)
    buf_valid = (torch.arange(cap, device=dev)
                 < torch.clamp(counts, max=cap)[..., None])
    return buf_tc, buf_valid, slot, kept


def _expert_ffn(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """Expert FFN over dispatch buffers (B,E,C,d) -> (B,E,C,d)."""
    dt = buf.dtype
    gate = torch.einsum("becd,edf->becf", buf, p["wi_gate"].to(dt))
    up = torch.einsum("becd,edf->becf", buf, p["wi_up"].to(dt))
    return torch.einsum("becf,efd->becd", F.silu(gate) * up, p["wo"].to(dt))


def route(cfg: ArchConfig, p: Params, x: torch.Tensor):
    """The router: (probs (B,S,E) f32, renormalized top-k weights (B,S,k)
    f32, expert choices idx (B,S,k))."""
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)       # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, cfg.experts_per_token)
    w = w / torch.sum(w, dim=-1, keepdim=True)                     # qwen3 renorm
    return probs, w, idx


def moe_apply(cfg: ArchConfig, p: Params, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux load-balance loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = capacity(cfg, s)
    dt = x.dtype
    probs, w, idx = route(cfg, p, x)

    # aux loss (switch-style): E * sum_e frac_dispatched_e * mean_prob_e
    sel = F.one_hot(idx[..., 0], e).to(torch.float32)              # top-1 frac
    aux = e * torch.mean(torch.mean(sel, dim=(0, 1)) * torch.mean(probs, dim=(0, 1)))

    buf_tc, buf_valid, slot, kept = _dispatch_indices(idx, e, cap)  # (B,E,C), (B,S*k)
    rows = torch.arange(b, device=x.device)[:, None]
    tok = buf_tc // k                                              # (B,E,C)
    buf = x[rows, tok.reshape(b, e * cap)]
    buf = buf.reshape(b, e, cap, d) * buf_valid[..., None].to(dt)

    yb = _expert_ffn(p, buf)                                       # (B,E,C,d)

    # combine: each token-choice gathers its expert/slot result
    flat_pos = idx.reshape(b, s * k).long() * cap + slot.clamp(0, cap - 1)
    ytc = yb.reshape(b, e * cap, d)[rows, flat_pos]
    ytc = ytc.reshape(b, s, k, d) * kept.reshape(b, s, k, 1).to(dt)
    y = torch.sum(ytc * w[..., None].to(dt), dim=2)
    return y, aux


def moe_block_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                    chunked: bool = False, return_kv: bool = False):
    """One moe block over the whole sequence: attention, then the MoE FFN
    on ``rmsnorm(ln2)``. Returns (x, aux, (k, v) or None)."""
    a = ly.attn_apply(cfg, p["attn"], ly.rmsnorm(p["ln1"], x), chunked=chunked,
                      return_kv=return_kv)
    a, kv = a if return_kv else (a, None)
    x = x + a
    y, aux = moe_apply(cfg, p["moe"], ly.rmsnorm(p["ln2"], x))
    return x + y, aux, kv


def moe_block_decode(cfg: ArchConfig, p: Params, x: torch.Tensor, cache: Params,
                     pos) -> tuple[torch.Tensor, Params]:
    """``moe_block_apply`` for one token per slot, its K/V written into
    ``cache`` (see ``layers.attn_decode``); at S = 1 the capacity is 1 and
    no choice drops."""
    a, new_cache = ly.attn_decode(cfg, p["attn"], ly.rmsnorm(p["ln1"], x), cache, pos)
    x = x + a
    y, _ = moe_apply(cfg, p["moe"], ly.rmsnorm(p["ln2"], x))
    return x + y, new_cache
