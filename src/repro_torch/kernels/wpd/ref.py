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
    taps = h.shape[0]
    # One periodized copy; tap k reads the stride-2 view starting at k.
    xp = x[..., torch.arange(n + taps - 2, device=x.device) % n]
    a = torch.zeros(x.shape[:-1] + (n // 2,), dtype=torch.float32, device=x.device)
    d = torch.zeros_like(a)
    term = torch.empty_like(a)
    for k, (hk, gk) in enumerate(zip(h.tolist(), g.tolist())):
        v = xp[..., k : k + n - 1 : 2]
        a += torch.mul(v, hk, out=term)
        d += torch.mul(v, gk, out=term)
    return a, d


def wpd_tree(x: torch.Tensor, h: torch.Tensor, g: torch.Tensor, level: int) -> torch.Tensor:
    """x (..., N) -> (..., 2**level, N / 2**level): ``level`` chained
    levels, every node split, in Paley order (node 2i is the low branch of
    node i, 2i+1 the high one)."""
    lead, n = x.shape[:-1], x.shape[-1]
    if n % (2**level) != 0:
        raise ValueError(f"signal length {n} not divisible by 2**{level}")
    nodes = x.unsqueeze(-2)
    for _ in range(level):
        a, d = wpd_level(nodes, h, g)
        nodes = torch.stack([a, d], dim=-2).reshape(lead + (a.shape[-2] * 2, a.shape[-1]))
    return nodes


def dwt_levels(
    x: torch.Tensor, h: torch.Tensor, g: torch.Tensor, level: int
) -> list[torch.Tensor]:
    """x (..., N) -> [D1, ..., D_level, A_level]: ``level`` chained levels,
    only the approximation split."""
    coeffs = []
    cur = x
    for _ in range(level):
        cur, d = wpd_level(cur, h, g)
        coeffs.append(d)
    coeffs.append(cur)
    return coeffs
