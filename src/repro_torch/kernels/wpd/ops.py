"""K2 router: one analysis level, a packet tree or a DWT of rows of any
leading shape."""

from __future__ import annotations

import torch

from repro_torch.kernels._route import on_cuda
from repro_torch.kernels.wpd import kernel as _kernel
from repro_torch.kernels.wpd import ref as _ref


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def wpd_level(
    x: torch.Tensor, h: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., N) -> (approx, detail), each (..., N/2), with the analysis
    filters h, g (CPU tensors, see ``signal.wavelet.filters``). A CUDA
    tensor goes through the kernel, a CPU tensor through the plain
    version."""
    if not on_cuda(x, "wpd_level"):
        return _ref.wpd_level(x, h, g)
    return _kernel.wpd_level(_rows(x), h, g)


def wpd_tree(x: torch.Tensor, h: torch.Tensor, g: torch.Tensor, level: int) -> torch.Tensor:
    """x (..., N) -> (..., 2**level, N / 2**level) terminal nodes of the
    packet tree in Paley order: one kernel launch on a CUDA tensor, the
    chained plain levels on a CPU tensor."""
    if not on_cuda(x, "wpd_tree"):
        return _ref.wpd_tree(x, h, g, level)
    return _kernel.wpd_tree(_rows(x), h, g, level)


def dwt_levels(
    x: torch.Tensor, h: torch.Tensor, g: torch.Tensor, level: int
) -> list[torch.Tensor]:
    """x (..., N) -> [D1 (..., N/2), ..., D_level, A_level], each scale its
    own contiguous tensor: one kernel launch on a CUDA tensor, the chained
    plain levels on a CPU tensor."""
    if not on_cuda(x, "dwt_levels"):
        return _ref.dwt_levels(x, h, g, level)
    return _kernel.dwt_levels(_rows(x), h, g, level)
