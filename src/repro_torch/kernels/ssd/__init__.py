from repro_torch.kernels.ssd import kernel, ops, ref
from repro_torch.kernels.ssd.ops import ssd_scan

__all__ = ["kernel", "ops", "ref", "ssd_scan"]
