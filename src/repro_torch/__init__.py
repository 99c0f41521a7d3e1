"""PyTorch + CUDA port of the seizure-scoring path of ``repro``.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``signal.wavelet``, ``core.pca``, ``serving.api``, ...)
and holds its outputs to the reference's in ``tests/test_torch_*.py``.
It imports ``torch`` and numpy only -- never ``jax``, never ``repro``.

Importing the package turns TF32 off for float32 matrix products and
convolutions: forest routing is a hard ``>`` against a threshold, and a
TF32 rounding near the threshold flips the route.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
