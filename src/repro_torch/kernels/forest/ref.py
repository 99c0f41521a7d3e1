"""Plain PyTorch version of K1: packed rotation-forest traversal.

A packed forest is three dense tensors (leading axis = tree):
proj (T, F, L) -- column i pulls heap node i's rotated split feature
back into raw feature space; thr (T, L) -- node i's raw-space threshold,
+inf for a dead node (always routes left); leaf_probs (T, L, C).
"""

from __future__ import annotations

import torch


def leaf_match(dirs: torch.Tensor) -> torch.Tensor:
    """(..., L) per-heap-node go-right booleans -> (..., L) one-hot leaf
    membership. Heap ids: root 1, children of i are 2i and 2i+1, slot 0
    unused; leaf l's ancestor at level j is 2**j + (l >> (depth - j)),
    and the direction out of it is bit (depth - 1 - j) of l."""
    l_leaves = dirs.shape[-1]
    depth = l_leaves.bit_length() - 1
    leaf_ids = torch.arange(l_leaves, device=dirs.device)
    match = torch.ones(dirs.shape, dtype=torch.bool, device=dirs.device)
    for j in range(depth):
        span = l_leaves >> j  # leaves under one level-j node
        taken = dirs[..., 2**j : 2 ** (j + 1)].repeat_interleave(span, dim=-1)
        want_right = ((leaf_ids >> (depth - 1 - j)) & 1) == 1
        match = match & (taken == want_right)
    return match


def forest_traverse(
    x: torch.Tensor, proj: torch.Tensor, thr: torch.Tensor, leaf_probs: torch.Tensor
) -> torch.Tensor:
    """x (B, F), packed forest -> (B, C) leaf probabilities SUMMED over
    trees in ascending order (callers divide by T)."""
    x = x.to(torch.float32)
    total = None
    for t in range(proj.shape[0]):
        match = leaf_match(x @ proj[t] > thr[t])
        probs = match.to(torch.float32) @ leaf_probs[t]
        total = probs if total is None else total + probs
    return total
