"""K6 router and the two-pass SSD schedule (twin of the JAX package's
``kernels/ssd/ops.py``): full sequence in, the per-chunk work in K6 on a
CUDA tensor (the plain version on a CPU tensor), the inter-chunk
recurrence a short torch loop over the chunks.

  1. chunk summaries with h_in = 0 -> local states;
  2. the (Dk, Dv) recurrence across chunks -> the true h_in of each chunk;
  3. the chunk step again with the true h_in -> exact y.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._route import on_cuda
from repro_torch.kernels.ssd import kernel as _kernel
from repro_torch.kernels.ssd import ref as _ref


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor, *,
             chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k: (BH, S, Dk); v: (BH, S, Dv); ld: (BH, S) log-decay <= 0.
    Returns (y (BH, S, Dv), final_state (BH, Dk, Dv) float32)."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk

    def split(t):
        return t.reshape(bh, nc, chunk, *t.shape[2:]).contiguous()

    qc, kc, vc, ldc = split(q), split(k), split(v), split(ld)
    run_chunks = _kernel.ssd_chunks if on_cuda(q, "ssd_scan") else _ref.ssd_chunks

    zeros = torch.zeros((bh, nc, dk, dv), dtype=torch.float32, device=q.device)
    _, local_states = run_chunks(qc, kc, vc, ldc, zeros)   # pass 1: summaries
    total = torch.sum(ldc.to(torch.float32), dim=2)        # (BH, NC)
    h = torch.zeros((bh, dk, dv), dtype=torch.float32, device=q.device)
    h_in = torch.empty_like(zeros)
    for c in range(nc):
        h_in[:, c] = h                                      # the state entering chunk c
        # local_states already include exp(total) * h_in with h_in = 0
        h = h * torch.exp(total[:, c])[:, None, None] + local_states[:, c]
    y, states_out = run_chunks(qc, kc, vc, ldc, h_in)       # pass 2: exact outputs
    # contiguous: a prefill keeps every block's final state, not its states_out
    return y.reshape(bh, s, dv), states_out[:, -1].contiguous()
