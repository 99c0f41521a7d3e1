"""K6 router and the two-pass SSD schedule (twin of the JAX package's
``kernels/ssd/ops.py``): full sequence in, the per-chunk work in K6 on a
CUDA tensor (the plain versions on a CPU tensor), the inter-chunk
recurrence a short torch loop over the chunks.

  1. the chunk states with no incoming state (K6's states mode);
  2. the (Dk, Dv) recurrence across chunks -> the true h_in of each chunk
     and the final state;
  3. the outputs given the true h_in (K6's outputs mode) -> exact y.

``ssd_scan_grouped`` takes the model's layout, one B/C row per batch row
shared by its heads; ``ssd_scan`` the JAX package's (BH, S, D) layout.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._route import on_cuda
from repro_torch.kernels.ssd import kernel as _kernel
from repro_torch.kernels.ssd import ref as _ref


def ssd_scan_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor, *,
                     chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """q = C, k = B: (B, S, N), each row's shared by its heads; v: (B, S, H,
    P); ld: (B, S, H) log-decay <= 0, all of one type. Returns (y (B, S, H,
    P) in that type, final_state (B, H, N, P) float32)."""
    b, s, n = q.shape
    h, p = v.shape[2:]
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    qc, kc = q.reshape(b, nc, chunk, n), k.reshape(b, nc, chunk, n)
    vc, ldc = v.reshape(b, nc, chunk, h, p), ld.reshape(b, nc, chunk, h)
    run = _kernel if on_cuda(q, "ssd_scan") else _ref

    local = run.ssd_chunk_states(kc, vc, ldc)               # pass 1: (B, H, NC, N, P)
    # Each chunk's decay, summed along contiguous rows (so that any grouping
    # of the heads sums each row in the same order).
    decay = torch.exp(ldc.movedim(3, 1).to(torch.float32).contiguous().sum(-1))  # (B, H, NC)
    decay = decay[..., None, None]
    # h_in[:, :, c] is the state entering chunk c; one fused update a chunk.
    h_in = torch.empty_like(local)
    h_in[:, :, 0] = 0.0
    for c in range(nc - 1):
        torch.addcmul(local[:, :, c], h_in[:, :, c], decay[:, :, c], out=h_in[:, :, c + 1])
    state = torch.addcmul(local[:, :, -1], h_in[:, :, -1], decay[:, :, -1])
    y = run.ssd_chunk_outputs(qc, kc, vc, ldc, h_in)        # pass 2: exact outputs
    return y.reshape(b, s, h, p), state


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor, *,
             chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k: (BH, S, Dk); v: (BH, S, Dv); ld: (BH, S) log-decay <= 0.
    Returns (y (BH, S, Dv), final_state (BH, Dk, Dv) float32): the grouped
    scan with one head per group."""
    y, state = ssd_scan_grouped(q, k, v[:, :, None], ld[:, :, None], chunk=chunk)
    return y[:, :, 0], state[:, 0]
