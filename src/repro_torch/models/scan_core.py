"""Chunkwise linear-attention / state-space core (twin of the JAX
package's ``models/scan_core.py``).

Mamba2's SSD is an instance of the gated linear recurrence

    h_t = exp(ld_t) * h_{t-1} + k_t v_t^T          h: (Dk, Dv) per head
    y_t = q_t . h_t

computed in chunked form: quadratic within a chunk, a short sequential
loop across chunks (the reference's ``lax.scan``).

Conventions: ``cum`` is the inclusive within-chunk cumsum of ``ld``; the
decay between positions j <= i (same chunk) is ``exp(cum_i - cum_j)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def chunked_linear_attention(
    q: torch.Tensor,          # (B, S, H, Dk)
    k: torch.Tensor,          # (B, S, H, Dk)
    v: torch.Tensor,          # (B, S, H, Dv)
    log_decay: torch.Tensor,  # (B, S, H) -- ld_t <= 0
    *,
    chunk: int = 256,
    initial_state: torch.Tensor | None = None,  # (B, H, Dk, Dv)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,Dv), final_state (B,H,Dk,Dv) float32)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if s % chunk:
        # Pad to a chunk multiple: k=v=0 contributes nothing to states,
        # ld=0 (decay 1) leaves the recurrence untouched; padded y rows
        # are sliced off below.
        pad = chunk - s % chunk

        def zf(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))

        y, state = chunked_linear_attention(
            zf(q), zf(k), zf(v), zf(log_decay), chunk=chunk,
            initial_state=initial_state)
        return y[:, :s], state
    nc = s // chunk
    dt = q.dtype

    def split(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    qc, kc, vc = split(q), split(k), split(v)
    ld = split(log_decay).to(torch.float32)             # (B,nc,L,H)
    cum = torch.cumsum(ld, dim=2)                       # inclusive
    total = cum[:, :, -1, :]                            # (B,nc,H)

    # ---- intra-chunk (quadratic in `chunk`) --------------------------------
    # decay(i,j) = exp(cum_i - cum_j) for j <= i, else 0
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,L,L,H)
    li = torch.arange(chunk, device=q.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    decay = torch.exp(torch.where(causal, rel, NEG_INF)).to(dt)
    scores = torch.einsum("bclhd,bcmhd->bclmh", qc, kc) * decay
    y_intra = torch.einsum("bclmh,bcmhv->bclhv", scores, vc)

    # ---- chunk summaries ----------------------------------------------------
    decay_to_end = torch.exp(total[:, :, None, :] - cum).to(dt)  # (B,nc,L,H)
    state_c = torch.einsum("bclhd,bclhv->bchdv", kc * decay_to_end[..., None], vc)

    # ---- inter-chunk recurrence (sequential over nc only) -------------------
    hst = (initial_state.to(torch.float32) if initial_state is not None
           else torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device))
    h_in = []
    for c in range(nc):
        h_in.append(hst)                                 # the state entering chunk c
        hst = hst * torch.exp(total[:, c])[:, :, None, None] + state_c[:, c].to(torch.float32)
    h_in = torch.stack(h_in, dim=1).to(dt)               # (B,nc,H,Dk,Dv)

    y_inter = torch.einsum("bclhd,bchdv->bclhv", qc * torch.exp(cum)[..., None].to(dt), h_in)
    y = (y_intra + y_inter).reshape(b, s, h, dv)
    return y, hst


def linear_attention_step(
    q: torch.Tensor,          # (B, H, Dk)
    k: torch.Tensor,
    v: torch.Tensor,          # (B, H, Dv)
    log_decay: torch.Tensor,  # (B, H)
    state: torch.Tensor,      # (B, H, Dk, Dv) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single decode step of the same recurrence, in float32. Returns (y,
    new_state)."""
    dec = torch.exp(log_decay.to(torch.float32))[:, :, None, None]
    new_state = dec * state + (k.to(torch.float32)[..., :, None]
                               * v.to(torch.float32)[..., None, :])
    y = torch.einsum("bhd,bhdv->bhv", q.to(torch.float32), new_state)
    return y.to(q.dtype), new_state
