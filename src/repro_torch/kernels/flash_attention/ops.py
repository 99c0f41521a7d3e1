"""K5 router (twin of the JAX package's ``kernels/flash_attention/ops.py``).

Takes model-layout tensors q (B, S, H, hd) and GQA k, v (B, S, K, hd). A
CUDA tensor goes to the kernel as it is: the kernel reads the KV groups and
the layout in place and returns (B, S, H, hd) contiguous, so nothing is
expanded, flattened or copied around the launch. A CPU tensor goes to the
plain version through ``reference``: the KV groups expanded, (B, H)
flattened, ``ref.attention``, and back to the model layout.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._route import on_cuda, refuse_grad
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


def reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """The plain version on the model layout, on any device: (B, S, H, hd)."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]

    def flat(t):
        return t.transpose(1, 2).reshape(b * h, s, hd)

    out = _ref.attention(flat(q), flat(k.repeat_interleave(g, dim=2)),
                         flat(v.repeat_interleave(g, dim=2)), causal=causal)
    return out.reshape(b, h, s, hd).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, K, hd) with H % K == 0. The kernel
    has no backward: a CUDA input that requires grad raises (the model's
    gate sends those to the plain attention paths)."""
    if on_cuda(q, "flash_attention"):
        refuse_grad("flash_attention", q, k, v)
        return _kernel.flash_attention(q, k, v, causal=causal)
    return reference(q, k, v, causal=causal)
