from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["flash_attention", "kernel", "ops", "ref"]
