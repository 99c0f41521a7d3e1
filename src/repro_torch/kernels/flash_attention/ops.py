"""K5 router (twin of the JAX package's ``kernels/flash_attention/ops.py``).

Accepts model-layout tensors (B, S, H, hd) with GQA K/V (B, S, K, hd),
expands the KV groups, flattens (B, H), and sends a CUDA tensor to the
kernel and a CPU tensor to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._route import on_cuda
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, K, hd) with H % K == 0."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)

    def flat(t):
        return t.transpose(1, 2).reshape(b * h, s, hd).contiguous()

    qf, kf, vf = flat(q), flat(k), flat(v)
    if on_cuda(q, "flash_attention"):
        out = _kernel.flash_attention(qf, kf, vf, causal=causal)
    else:
        out = _ref.attention(qf, kf, vf, causal=causal)
    return out.reshape(b, h, s, hd).transpose(1, 2)
