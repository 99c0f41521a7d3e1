"""Plain PyTorch version of K5 (twin of the JAX package's
``kernels/flash_attention/ref.py``).

Layout: q, k, v are (BH, S, hd) -- batch and heads pre-flattened (GQA
group expansion happens in ops.py). f32 softmax, causal optional; the
softmax weights are rounded to the input type before the weighted sum.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    bh, s, hd = q.shape
    logits = torch.einsum("bqd,bkd->bqk", q, k).to(torch.float32)
    logits = logits / math.sqrt(hd)
    if causal:
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(s, device=q.device)[None, :]
        logits = torch.where(j <= i, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bqk,bkd->bqd", w, v)
