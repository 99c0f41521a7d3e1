"""K2 router: one analysis level of rows of any leading shape."""

from __future__ import annotations

import torch

from repro_torch.kernels._route import on_cuda
from repro_torch.kernels.wpd import kernel as _kernel
from repro_torch.kernels.wpd import ref as _ref


def wpd_level(
    x: torch.Tensor, h: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., N) -> (approx, detail), each (..., N/2), with the analysis
    filters h, g (CPU tensors, see ``signal.wavelet.filters``). A CUDA
    tensor goes through the kernel, a CPU tensor through the plain
    version."""
    if not on_cuda(x, "wpd_level"):
        return _ref.wpd_level(x, h, g)
    lead, n = x.shape[:-1], x.shape[-1]
    a, d = _kernel.wpd_level(
        x.to(torch.float32).reshape(-1, n).contiguous(), h, g
    )
    return a.reshape(lead + (n // 2,)), d.reshape(lead + (n // 2,))
