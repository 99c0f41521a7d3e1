"""Plain PyTorch version of K6, the SSD intra-chunk step (twin of the JAX
package's ``kernels/ssd/ref.py``).

One chunk of the gated linear recurrence (models/scan_core.py):

    y_intra[l] = sum_{m<=l} exp(cum[l]-cum[m]) (q[l].k[m]) v[m]
    state_out  = sum_l exp(cum[end]-cum[l]) k[l] v[l]^T + exp(cum[end]) h_in
    y          = y_intra + exp(cum[l]) * (q[l] . h_in)

``ssd_chunk`` takes one chunk per row -- q, k: (BH, L, Dk), v: (BH, L,
Dv), log-decay ld: (BH, L), h_in: (BH, Dk, Dv) -- with the reference's
casts: the decay, the incoming-state factor exp(cum) and h_in are rounded
to q's type before the products, each product comes out in that type,
and the state is float32. ``ssd_chunks`` is the same function on the
kernel's batched-over-chunks layout (``kernel.ssd_chunks``);
``ssd_chunk_states`` and ``ssd_chunk_outputs`` are its two halves on the
kernel's grouped layout (``kernel.ssd_chunk_states`` / ``_outputs``): the
state with no incoming state, and y.
"""

from __future__ import annotations

import torch


def _chunk_y(q, k, v, cum, h_in):
    li = torch.arange(q.shape[1], device=q.device)
    causal = li[:, None] >= li[None, :]
    # Select, never multiply: exp(rel) above the diagonal may be inf.
    rel = cum[:, :, None] - cum[:, None, :]                           # (BH, L, L)
    decay = torch.where(causal[None], torch.exp(rel), 0.0).to(q.dtype)
    scores = torch.einsum("bld,bmd->blm", q, k) * decay
    y = torch.einsum("blm,bmv->blv", scores, v)
    return y + torch.einsum("bld,bdv->blv", q * torch.exp(cum)[..., None].to(q.dtype),
                            h_in.to(q.dtype))


def _chunk_state(k, v, cum):
    """The state of a chunk entering with no state."""
    dte = torch.exp(cum[:, -1:, None] - cum[..., None]).to(k.dtype)  # (BH, L, 1)
    return torch.einsum("bld,blv->bdv", k * dte, v).to(torch.float32)


def ssd_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
              h_in: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    cum = torch.cumsum(ld.to(torch.float32), dim=1)                   # (BH, L)
    y = _chunk_y(q, k, v, cum, h_in)
    state = (_chunk_state(k, v, cum)
             + h_in.to(torch.float32) * torch.exp(cum[:, -1])[:, None, None])
    return y, state


def ssd_chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
               h_in: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k: (BH, NC, L, Dk); v: (BH, NC, L, Dv); ld: (BH, NC, L); h_in:
    (BH, NC, Dk, Dv), the state entering each chunk. Returns (y (BH, NC,
    L, Dv) in q's type, state_out (BH, NC, Dk, Dv) float32)."""
    bh, nc, l, dk = q.shape
    dv = v.shape[-1]

    def flat(t):
        return t.reshape(bh * nc, *t.shape[2:])

    y, state = ssd_chunk(flat(q), flat(k), flat(v), flat(ld), flat(h_in))
    return y.reshape(bh, nc, l, dv), state.reshape(bh, nc, dk, dv)


def _heads_qk(t: torch.Tensor, hg: int) -> torch.Tensor:
    """q or k (G, NC, L, D), broadcast over the heads, as one chunk per row
    in (group, head, chunk) order."""
    g, nc, l, d = t.shape
    return t[:, None].expand(g, hg, nc, l, d).reshape(g * hg * nc, l, d)


def _heads(t: torch.Tensor) -> torch.Tensor:
    """v (G, NC, L, Hg, D) or ld (G, NC, L, Hg) as one chunk per row in
    (group, head, chunk) order."""
    g, nc, l, hg = t.shape[:4]
    t = t.movedim(3, 1)
    return t.reshape(g * hg * nc, l, *t.shape[4:])


def ssd_chunk_states(k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor) -> torch.Tensor:
    """k (G, NC, L, Dk), v (G, NC, L, Hg, Dv), ld (G, NC, L, Hg) -> the
    state of each chunk entering with no state, (G, Hg, NC, Dk, Dv)
    float32."""
    g, nc, _, dk = k.shape
    hg, dv = v.shape[3:]
    cum = torch.cumsum(_heads(ld).to(torch.float32), dim=1)
    return _chunk_state(_heads_qk(k, hg), _heads(v), cum).reshape(g, hg, nc, dk, dv)


def ssd_chunk_outputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
                      h_in: torch.Tensor) -> torch.Tensor:
    """q, k (G, NC, L, Dk), v (G, NC, L, Hg, Dv), ld (G, NC, L, Hg), h_in
    (G, Hg, NC, Dk, Dv) the state entering each chunk -> y (G, NC, L, Hg,
    Dv) in q's type, contiguous."""
    g, nc, l, dk = q.shape
    hg, dv = v.shape[3:]
    cum = torch.cumsum(_heads(ld).to(torch.float32), dim=1)
    y = _chunk_y(_heads_qk(q, hg), _heads_qk(k, hg), _heads(v), cum,
                 h_in.reshape(g * hg * nc, dk, dv))
    return y.reshape(g, hg, nc, l, dv).permute(0, 2, 3, 1, 4).contiguous()
