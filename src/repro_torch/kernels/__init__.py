"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package keeps the JAX package's split: ``kernel.py`` (the ctypes
wrapper of the CUDA C++ kernel in ``repro_torch/csrc``, with its
``LAUNCHES`` count), ``ref.py`` (the plain PyTorch version of the same
contract) and ``ops.py`` (routes a CPU tensor to the plain version and a
CUDA tensor to the kernel).
"""

from repro_torch.kernels import build, flash_attention, forest, gram, histogram, ssd, wpd

__all__ = ["build", "flash_attention", "forest", "gram", "histogram", "ssd", "wpd"]
