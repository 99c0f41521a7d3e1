"""Plain PyTorch version of K2: one periodized analysis level."""

from __future__ import annotations

import torch


def wpd_level(
    x: torch.Tensor, h: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., N) -> (a, d), each (..., N/2):
    a[m] = sum_k h[k] x[(2m + k) mod N], likewise d with g, summed over
    ascending k (the kernel's order)."""
    n = x.shape[-1]
    if n % 2:
        raise ValueError(f"row length {n} must be even")
    x = x.to(torch.float32)
    base = 2 * torch.arange(n // 2, device=x.device)
    a = torch.zeros(x.shape[:-1] + (n // 2,), dtype=torch.float32, device=x.device)
    d = torch.zeros_like(a)
    for k, (hk, gk) in enumerate(zip(h.tolist(), g.tolist())):
        v = x[..., (base + k) % n]
        a = a + hk * v
        d = d + gk * v
    return a, d
