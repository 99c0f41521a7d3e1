from repro_torch.kernels.wpd import kernel, ops, ref

__all__ = ["kernel", "ops", "ref"]
