from repro_torch.kernels.forest import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
