"""K3 router: batched Gram matrices."""

from __future__ import annotations

import torch

from repro_torch.kernels._route import on_cuda
from repro_torch.kernels.gram import kernel as _kernel
from repro_torch.kernels.gram import ref as _ref


def gram(x: torch.Tensor) -> torch.Tensor:
    """x (..., n, p) -> (..., p, p) = x^T x. A CUDA tensor goes through
    the kernel (leading axes folded into its batch; a transposed view is
    read in place), a CPU tensor through the plain version."""
    if not on_cuda(x, "gram"):
        return _ref.gram(x)
    lead, (n, p) = x.shape[:-2], x.shape[-2:]
    out = _kernel.gram(x.to(torch.float32).reshape((-1, n, p)))
    return out.reshape(lead + (p, p))
