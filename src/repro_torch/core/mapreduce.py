"""MapReduce on one device: the reducers and ``MapReduce.run_local`` of
``repro.core.mapreduce``, in PyTorch.

The reference runs a map function per shard (``shard_map`` over a mesh,
or ``vmap`` emulation) and reduces across a named axis with a collective.
Here the shards are emulated one after the other: ``run_local`` splits
each input's leading axis into ``n_shards`` equal shards, calls the map
function on each in shard order, and a reducer folds the list of
per-shard results (any nesting of tuples, lists, dicts and tensors) in
that order. The reducers are commutative monoids, as Hadoop asks of
combiners, so the order changes at most the float rounding of a sum.

``MapReduce.run`` over a mesh and ``shuffle_by_key`` wait for a
``torch.distributed`` slice of the port (ROADMAP.md queue 1, "Distributed
training").
"""

from __future__ import annotations

from typing import Any, Callable

import torch

MapFn = Callable[..., Any]
ReduceFn = Callable[[list], Any]


def _tree_map(fn: Callable, trees: list) -> Any:
    """Apply ``fn`` to the list of corresponding leaves of equally shaped
    trees (tensors inside tuples, named tuples, lists and dicts)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(trees)
    if isinstance(first, dict):
        return {k: _tree_map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_tree_map(fn, list(v)) for v in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, list(v)) for v in zip(*trees))
    raise TypeError(f"unsupported leaf type {type(first).__name__}")


def _sum(leaves: list) -> torch.Tensor:
    total = leaves[0]
    for leaf in leaves[1:]:
        total = total + leaf
    return total


def reduce_sum(mapped: list) -> Any:
    """Elementwise sum over the shards, in shard order."""
    return _tree_map(_sum, mapped)


def reduce_mean(mapped: list) -> Any:
    return _tree_map(lambda leaves: _sum(leaves) / len(leaves), mapped)


def reduce_max(mapped: list) -> Any:
    return _tree_map(lambda leaves: torch.stack(leaves).amax(dim=0), mapped)


def reduce_concat(mapped: list) -> Any:
    """Union reduce: the shards' leading axes concatenated in shard order
    (per-shard scalars are stacked). This is the forest union of the
    paper: each map task trains a sub-forest, the ensemble is their
    concatenation."""
    return _tree_map(
        lambda leaves: torch.cat(leaves) if leaves[0].dim() else torch.stack(leaves), mapped
    )


class MapReduce:
    """A Hadoop-style job: ``map_fn`` per shard, ``reduce_fn`` over the
    list of per-shard results."""

    def __init__(self, map_fn: MapFn, reduce_fn: ReduceFn = reduce_concat):
        self.map_fn = map_fn
        self.reduce_fn = reduce_fn

    def run(self, *args, **kwargs):
        raise NotImplementedError(
            "MapReduce.run over a device mesh is not ported yet (ROADMAP.md "
            "queue 1, Distributed training: the torch.distributed mode); use run_local"
        )

    def run_local(self, n_shards: int, *inputs, replicated_inputs: tuple = ()):
        """Split each input's leading axis into ``n_shards`` equal shards,
        map each shard in order (``replicated_inputs`` passed whole to
        every shard), and reduce."""
        for t in inputs:
            if t.shape[0] % n_shards:
                raise ValueError(
                    f"leading axis {t.shape[0]} does not split into {n_shards} equal shards"
                )
        shards = [t.chunk(n_shards) for t in inputs]
        mapped = [
            self.map_fn(*(s[i] for s in shards), *replicated_inputs) for i in range(n_shards)
        ]
        return self.reduce_fn(mapped)


__all__ = ["MapReduce", "reduce_concat", "reduce_max", "reduce_mean", "reduce_sum"]
