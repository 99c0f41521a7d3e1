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

With ``wg_constrain`` (the mesh Model's ``_wg_constrain``, under
``build(moe_wg=True)``) the expert FFN takes the reference's hand-written
VJP (``_ExpertFFN``): the backward recomputes the activations from the
saved buffer and hands each weight gradient to ``wg_constrain``, which
places it as the expert parameters are placed. Without it autograd
differentiates the plain einsums, as the reference's does.

On a mesh (``sh``) the router (its sort), the dispatch (a per-group
sort and ``scatter_add_``, for which DTensor has no strategy) and the
combine gather run on each rank's rows (``ActMesh.local``); the expert
FFN is DTensor einsums, and ``buf_constrain`` places the (B, E, C, d)
buffers around it: groups over the batch axes, experts over 'model'.
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


def _ffn_math(buf, wig, wiu, wo):
    gate = torch.einsum("becd,edf->becf", buf, wig)
    up = torch.einsum("becd,edf->becf", buf, wiu)
    return torch.einsum("becf,efd->becd", F.silu(gate) * up, wo)


class _ExpertFFN(torch.autograd.Function):
    """The reference's ``custom_vjp`` expert FFN: only the inputs are
    saved; the backward recomputes gate and up, and each weight gradient's
    einsum goes through ``wg_constrain``."""

    @staticmethod
    def forward(ctx, buf, wig, wiu, wo, wg_constrain):
        ctx.save_for_backward(buf, wig, wiu, wo)
        ctx.wg_constrain = wg_constrain
        return _ffn_math(buf, wig, wiu, wo)

    @staticmethod
    def backward(ctx, dy):
        buf, wig, wiu, wo = ctx.saved_tensors
        wg_constrain = ctx.wg_constrain
        dt = buf.dtype
        gate = torch.einsum("becd,edf->becf", buf, wig)     # remat
        up = torch.einsum("becd,edf->becf", buf, wiu)
        sg = F.silu(gate)
        h = sg * up
        d_h = torch.einsum("becd,efd->becf", dy, wo)
        d_wo = wg_constrain(torch.einsum("becf,becd->efd", h, dy))
        sig = torch.sigmoid(gate.to(torch.float32)).to(dt)
        d_gate = d_h * up * (sig + gate * sig * (1 - sig))
        d_up = d_h * sg
        d_wig = wg_constrain(torch.einsum("becd,becf->edf", buf, d_gate))
        d_wiu = wg_constrain(torch.einsum("becd,becf->edf", buf, d_up))
        d_buf = (torch.einsum("becf,edf->becd", d_gate, wig)
                 + torch.einsum("becf,edf->becd", d_up, wiu))
        return d_buf, d_wig, d_wiu, d_wo, None


def _expert_ffn(cfg: ArchConfig, p: Params, buf: torch.Tensor,
                wg_constrain=None) -> torch.Tensor:
    """Expert FFN over dispatch buffers (B,E,C,d) -> (B,E,C,d); with
    ``wg_constrain`` through the hand-written VJP (``_ExpertFFN``)."""
    dt = buf.dtype
    wig, wiu, wo = p["wi_gate"].to(dt), p["wi_up"].to(dt), p["wo"].to(dt)
    if wg_constrain is None:
        return _ffn_math(buf, wig, wiu, wo)
    return _ExpertFFN.apply(buf, wig, wiu, wo, wg_constrain)


def route(cfg: ArchConfig, p: Params, x: torch.Tensor):
    """The router: (probs (B,S,E) f32, renormalized top-k weights (B,S,k)
    f32, expert choices idx (B,S,k))."""
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)       # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, cfg.experts_per_token)
    w = w / torch.sum(w, dim=-1, keepdim=True)                     # qwen3 renorm
    return probs, w, idx


def _dispatch(x: torch.Tensor, idx: torch.Tensor, e: int, k: int, cap: int):
    """(buf (B,E,C,d) of each group's first C choices per expert, zero
    where empty; slot and kept (B, S*k) of every choice)."""
    b, _, d = x.shape
    buf_tc, buf_valid, slot, kept = _dispatch_indices(idx, e, cap)  # (B,E,C), (B,S*k)
    rows = torch.arange(b, device=x.device)[:, None]
    tok = buf_tc // k                                              # (B,E,C)
    buf = x[rows, tok.reshape(b, e * cap)]
    buf = buf.reshape(b, e, cap, d) * buf_valid[..., None].to(x.dtype)
    return buf, slot, kept


def _combine(yb: torch.Tensor, idx: torch.Tensor, slot: torch.Tensor, kept: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """Each token-choice gathers its expert/slot result; (B, S, d)."""
    b, e, cap, d = yb.shape
    s, k = idx.shape[1], idx.shape[2]
    dt = yb.dtype
    rows = torch.arange(b, device=yb.device)[:, None]
    flat_pos = idx.reshape(b, s * k).long() * cap + slot.clamp(0, cap - 1)
    ytc = yb.reshape(b, e * cap, d)[rows, flat_pos]
    ytc = ytc.reshape(b, s, k, d) * kept.reshape(b, s, k, 1).to(dt)
    return torch.sum(ytc * w[..., None].to(dt), dim=2)


def _expert_weights_on_mesh(cfg: ArchConfig, sh, p: Params, dt: torch.dtype) -> Params:
    """The expert weights in the compute dtype, gathered over the FSDP rows
    and kept split as the buffers are: experts over 'model' (expert
    parallel) when E divides it, else the FFN dim over 'model' (tensor
    parallel within each expert), so the expert einsums run shard against
    shard."""
    from repro_torch.sharding import rules

    if sh.heads(cfg.n_experts) or sh.tp == 1:
        e_ax = sh.heads(cfg.n_experts)
        specs = {"wi_gate": (e_ax,), "wi_up": (e_ax,), "wo": (e_ax,)}
    else:
        f_ax = sh.heads(cfg.d_ff)
        specs = {"wi_gate": (None, None, f_ax), "wi_up": (None, None, f_ax),
                 "wo": (None, f_ax, None)}
    return {name: rules.place(p[name].to(dt), sh.mesh, spec) for name, spec in specs.items()}


def moe_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, wg_constrain=None,
              buf_constrain=None, sh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux load-balance loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = capacity(cfg, s)
    if sh is None:
        probs, w, idx = route(cfg, p, x)
    else:
        be = (sh.batch(b),)
        probs, w, idx = sh.local(lambda xl, r: route(cfg, {"router": r}, xl),
                                 (x, p["router"]), [be, ()], (be, be, be))

    # aux loss (switch-style): E * sum_e frac_dispatched_e * mean_prob_e
    sel = F.one_hot(idx[..., 0], e).to(torch.float32)              # top-1 frac
    aux = e * torch.mean(torch.mean(sel, dim=(0, 1)) * torch.mean(probs, dim=(0, 1)))

    if sh is None:
        buf, slot, kept = _dispatch(x, idx, e, k, cap)
    else:
        be = (sh.batch(b),)
        buf, slot, kept = sh.local(lambda xl, il: _dispatch(xl, il, e, k, cap), (x, idx),
                                   [be, be], (be, be, be))
    if buf_constrain is not None:
        # pin (groups->batch axes, experts->model)
        buf = buf_constrain(buf)

    if sh is not None:
        p = _expert_weights_on_mesh(cfg, sh, p, x.dtype)
    yb = _expert_ffn(cfg, p, buf, wg_constrain)                    # (B,E,C,d)
    if buf_constrain is not None:
        yb = buf_constrain(yb)

    if sh is None:
        y = _combine(yb, idx, slot, kept, w)
    else:
        y = sh.local(_combine, (yb, idx, slot, kept, w), [be] * 5, be)
    return y, aux


def moe_block_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                    chunked: bool = False, return_kv: bool = False, sh=None, cp=None,
                    wg_constrain=None, buf_constrain=None):
    """One moe block over the whole sequence: attention, then the MoE FFN
    on ``rmsnorm(ln2)``. Returns (x, aux, (k, v) or None)."""
    a = ly.attn_apply(cfg, p["attn"], ly.rmsnorm(p["ln1"], x), chunked=chunked,
                      return_kv=return_kv, sh=sh, cp=cp)
    a, kv = a if return_kv else (a, None)
    x = ly._resid(sh, x + a)
    y, aux = moe_apply(cfg, p["moe"], ly.rmsnorm(p["ln2"], x), wg_constrain=wg_constrain,
                       buf_constrain=buf_constrain, sh=sh)
    return ly._resid(sh, x + y), aux, kv


def moe_block_decode(cfg: ArchConfig, p: Params, x: torch.Tensor, cache: Params,
                     pos, sh=None) -> tuple[torch.Tensor, Params]:
    """``moe_block_apply`` for one token per slot, its K/V written into
    ``cache`` (see ``layers.attn_decode``); at S = 1 the capacity is 1 and
    no choice drops. The reference's decode takes no constrain callables."""
    a, new_cache = ly.attn_decode(cfg, p["attn"], ly.rmsnorm(p["ln1"], x), cache, pos, sh=sh)
    x = ly._resid(sh, x + a)
    y, _ = moe_apply(cfg, p["moe"], ly.rmsnorm(p["ln2"], x), sh=sh)
    return ly._resid(sh, x + y), new_cache
