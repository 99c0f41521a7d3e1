"""Device routing shared by the kernel ops."""

from __future__ import annotations

import torch


def on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"{what}: no kernel or plain version for {x.device}")


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise if an input of a kernel with no backward requires grad: its
    output would carry no gradient back, silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward and an input requires grad; "
            "gradients take the plain paths (the model's gate sends them there)"
        )
