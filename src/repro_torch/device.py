"""Device resolution and the float32 precision settings of the port.

Entry points take ``device=None`` and resolve it here: ``None`` means
the CUDA card, and with no card the call raises instead of quietly
running on the CPU. The CPU runs only when the caller asks for it with
``device="cpu"`` (the CPU tests do).
"""

from __future__ import annotations

import torch

# True float32 everywhere: the JAX reference computes its products with
# float32 accumulation, and the forest's split compares are exact.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raising when no card is visible); anything
    else is taken as asked, and a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain CPU path"
        )
    return dev
