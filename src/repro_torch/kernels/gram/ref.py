"""Plain PyTorch version of K3: G = X^T X in float32."""

from __future__ import annotations

import torch


def gram(x: torch.Tensor) -> torch.Tensor:
    """x (..., n, p) -> (..., p, p) = x^T x (a true float32 product: the
    package turns TF32 off)."""
    x = x.to(torch.float32)
    return x.transpose(-1, -2) @ x
