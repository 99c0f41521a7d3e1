from repro_torch.kernels.histogram import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
