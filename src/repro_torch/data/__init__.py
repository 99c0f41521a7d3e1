"""Synthetic batches and the deterministic batch stream (twin of the JAX
package's ``data``)."""

from repro_torch.data.synthetic import batch_specs, make_batch

__all__ = ["make_batch", "batch_specs"]
