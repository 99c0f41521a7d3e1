"""Principal component analysis in PyTorch (the twin of ``repro.core.pca``).

Every function takes optional leading batch axes: MSPCA fits one PCA per
wavelet scale for all chunks of an engine step at once. The covariance
goes through ``kernels.gram`` (K3 on a CUDA tensor); the eigensolver is
``torch.linalg.eigh`` (cuSOLVER on the card, LAPACK on the CPU), a
library call where the reference also calls one. Bases of degenerate
eigenvalues are solver-dependent: compare PCA results by their
reconstructions, never by raw components.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.gram import ops as gram_ops


class PCAState(NamedTuple):
    """components (..., F, F): columns are principal directions by
    decreasing eigenvalue; mean (..., F); variances (..., F)."""

    components: torch.Tensor
    mean: torch.Tensor
    variances: torch.Tensor


def _eig_sorted(cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Descending eigendecomposition with the reference's sign convention:
    the largest-|.| entry of each component is made positive (first such
    entry on ties)."""
    evals, evecs = torch.linalg.eigh(cov)
    order = torch.argsort(-evals, dim=-1, stable=True)
    evals = evals.gather(-1, order)
    evecs = evecs.gather(-1, order.unsqueeze(-2).expand_as(evecs))
    pivot = evecs.abs().argmax(dim=-2, keepdim=True)
    signs = torch.sign(evecs.gather(-2, pivot))
    return evals, evecs * torch.where(signs == 0, 1.0, signs)


def _state(mean: torch.Tensor, cov: torch.Tensor) -> PCAState:
    evals, evecs = _eig_sorted(cov)
    return PCAState(components=evecs, mean=mean, variances=evals.clamp(min=0.0))


def fit(x: torch.Tensor) -> PCAState:
    """Fit on x (..., N, F), samples along N; all components are kept."""
    x = x.to(torch.float32)
    mean = x.mean(dim=-2)
    cov = gram_ops.gram(x - mean.unsqueeze(-2)) / max(x.shape[-2] - 1, 1)
    return _state(mean, cov)


def fit_T(xT: torch.Tensor) -> PCAState:
    """Fit on the transposed layout xT (..., F, N), samples along N --
    MSPCA's per-scale coefficients as the DWT leaves them. The Gram
    kernel reads the centered block through a transposed view."""
    xT = xT.to(torch.float32)
    mean = xT.mean(dim=-1)
    xc = xT - mean.unsqueeze(-1)
    cov = gram_ops.gram(xc.transpose(-1, -2)) / max(xT.shape[-1] - 1, 1)
    return _state(mean, cov)


def _keep_mask(keep: torch.Tensor, f: int, device) -> torch.Tensor:
    """(..., F) 0/1 float mask of the first ``keep`` components."""
    return (torch.arange(f, device=device) < keep.unsqueeze(-1)).to(torch.float32)


def reconstruct(
    state: PCAState, x: torch.Tensor, keep: int | torch.Tensor
) -> torch.Tensor:
    """Project x (..., N, F) onto the leading ``keep`` components and back.
    An int slices the components; a tensor count (per batch entry) masks
    the scores instead."""
    xc = x - state.mean.unsqueeze(-2)
    if isinstance(keep, int):
        comps = state.components[..., : min(keep, state.components.shape[-1])]
        return (xc @ comps) @ comps.transpose(-1, -2) + state.mean.unsqueeze(-2)
    scores = xc @ state.components
    mask = _keep_mask(keep, scores.shape[-1], x.device).unsqueeze(-2)
    return (scores * mask) @ state.components.transpose(-1, -2) + state.mean.unsqueeze(-2)


def reconstruct_T(
    state: PCAState, xT: torch.Tensor, keep: int | torch.Tensor
) -> torch.Tensor:
    """Transposed-layout ``reconstruct``: (..., F, N) -> (..., F, N)."""
    xc = xT - state.mean.unsqueeze(-1)
    if isinstance(keep, int):
        comps = state.components[..., : min(keep, state.components.shape[-1])]
        return comps @ (comps.transpose(-1, -2) @ xc) + state.mean.unsqueeze(-1)
    scores = state.components.transpose(-1, -2) @ xc
    mask = _keep_mask(keep, scores.shape[-2], xT.device).unsqueeze(-1)
    return state.components @ (scores * mask) + state.mean.unsqueeze(-1)


def kaiser_rule(state: PCAState) -> torch.Tensor:
    """Components with eigenvalue above the mean eigenvalue (at least 1)."""
    above = state.variances > state.variances.mean(dim=-1, keepdim=True)
    return above.sum(dim=-1).clamp(min=1)
