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
kernel's batched-over-chunks layout (``kernel.ssd_chunks``).
"""

from __future__ import annotations

import torch


def ssd_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
              h_in: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    cum = torch.cumsum(ld.to(torch.float32), dim=1)                   # (BH, L)
    rel = cum[:, :, None] - cum[:, None, :]                           # (BH, L, L)
    li = torch.arange(q.shape[1], device=q.device)
    causal = li[:, None] >= li[None, :]
    # Select, never multiply: exp(rel) above the diagonal may be inf.
    decay = torch.where(causal[None], torch.exp(rel), 0.0).to(q.dtype)
    scores = torch.einsum("bld,bmd->blm", q, k) * decay
    y = torch.einsum("blm,bmv->blv", scores, v)
    y = y + torch.einsum("bld,bdv->blv", q * torch.exp(cum)[..., None].to(q.dtype),
                         h_in.to(q.dtype))
    dte = torch.exp(cum[:, -1:, None] - cum[..., None]).to(q.dtype)  # (BH, L, 1)
    state = (torch.einsum("bld,blv->bdv", k * dte, v).to(torch.float32)
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
