from repro_torch.kernels.gram import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
