"""MapReduce in PyTorch: the twin of ``repro.core.mapreduce``.

A job maps each row shard of its inputs and reduces the list of
per-shard results. Two modes share one job and one body:

  * ``run(mesh, ...)``: one process per map task over
    ``torch.distributed`` (the reference's ``shard_map``). ``mesh`` is a
    ``torch.distributed.device_mesh.DeviceMesh`` with a ``"data"``
    dimension; every rank calls ``run`` with the same global inputs,
    maps rows ``[r n / S, (r + 1) n / S)`` of each input's leading axis
    and returns the same reduced result.
  * ``run_local(n_shards, ...)``: the shards emulated one after the
    other in one process (the reference's ``vmap``).

The reference's reducers are collectives over a named axis (``psum``,
``all_gather``). Here a reducer folds the list of per-shard results (any
nesting of tuples, named tuples, lists, dicts and tensors) in shard
order. On a mesh every rank all-gathers each leaf of its result from
every rank of the axis and folds the gathered list with the same
reducer, so a mesh of S ranks returns exactly what ``run_local(S)``
returns on the same device type. ``all_reduce`` is not used: its
summation order depends on the backend. A reducer of the caller's own
(any ``list -> tree``) works the same way in both modes. The reducers
are commutative monoids, as Hadoop asks of combiners.

``shuffle_by_key`` is the keyed exchange between map shards
(``all_to_all_single`` on a mesh, ``shuffle_by_key_local`` emulated).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

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


def _leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a tree, in ``_tree_map``'s order."""
    out: list[torch.Tensor] = []
    _tree_map(lambda ls: out.append(ls[0]), [tree])
    return out


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


# ---------------------------------------------------------------------------
# Where the shards run
# ---------------------------------------------------------------------------

def axis_group(mesh, axis_name: str = "data"):
    """The process group of ``mesh``'s ``axis_name`` dimension."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if axis_name not in names:
        raise ValueError(f"mesh has no {axis_name!r} dimension (dims {names})")
    return mesh.get_group(axis_name)


def all_gather_tree(tree: Any, group) -> list:
    """Every rank's ``tree`` from every rank of ``group``, in rank order.

    Each leaf goes through ``dist.all_gather`` as it lies: a collective
    on a CUDA tensor under ``gloo`` is staged through host memory by the
    backend itself (gloo copies the tensor to the host, exchanges it over
    its sockets and copies the result back to the card). Leaves must have
    the same shape and dtype on every rank, as under ``shard_map``: that
    is checked first (one ``all_gather_object`` of the leaves' specs) and
    a mismatch raises on every rank.
    """
    leaves = _leaves(tree)
    spec = [(tuple(t.shape), str(t.dtype)) for t in leaves]
    size = dist.get_world_size(group)
    specs: list = [None] * size
    dist.all_gather_object(specs, spec, group=group)
    for rank, other in enumerate(specs):
        if other != spec:
            raise ValueError(
                f"mapped leaves differ across ranks: rank {dist.get_rank(group)} has {spec}, "
                f"rank {rank} has {other}; every rank must map to the same shapes"
            )
    gathered = []
    for t in leaves:
        flat = t.contiguous().view(-1)
        out = [torch.empty_like(flat) for _ in range(size)]
        dist.all_gather(out, flat, group=group)
        gathered.append([o.view(t.shape) for o in out])
    per_rank = []
    for r in range(size):
        it = iter(g[r] for g in gathered)
        per_rank.append(_tree_map(lambda _: next(it), [tree]))
    return per_rank


class Shards(NamedTuple):
    """Where a job's shards run. ``count`` shards in all; ``held`` the
    indices of those this process maps (all of them in the emulation, its
    rank along the mesh axis on a mesh); ``group`` the axis's process
    group (None in the emulation)."""

    count: int
    held: tuple[int, ...]
    group: Any = None

    def split(self, t: torch.Tensor) -> list[torch.Tensor]:
        """The held shards' rows of ``t``'s leading axis (equal shards)."""
        if t.shape[0] % self.count:
            raise ValueError(
                f"leading axis {t.shape[0]} does not split into {self.count} equal shards"
            )
        n = t.shape[0] // self.count
        return [t[i * n : (i + 1) * n] for i in self.held]

    def gather(self, mapped: list) -> list:
        """The held shards' results -> every shard's, in shard order."""
        if self.group is None:
            return list(mapped)
        (mine,) = mapped
        return all_gather_tree(mine, self.group)


def local_shards(n_shards: int) -> Shards:
    """All ``n_shards`` shards in this process, one after the other."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    return Shards(n_shards, tuple(range(n_shards)))


def mesh_shards(mesh, axis_name: str = "data") -> Shards:
    """This rank's shard of ``mesh``'s ``axis_name`` dimension: shard r is
    the rank of group rank r, the order ``all_gather`` returns."""
    group = axis_group(mesh, axis_name)
    return Shards(dist.get_world_size(group), (dist.get_rank(group),), group)


# ---------------------------------------------------------------------------
# The MapReduce job
# ---------------------------------------------------------------------------

class MapReduce:
    """A Hadoop-style job: ``map_fn`` per shard, ``reduce_fn`` over the
    list of per-shard results in shard order. ``axis_name`` names the
    mesh dimension that carries the input splits."""

    def __init__(self, map_fn: MapFn, reduce_fn: ReduceFn = reduce_concat,
                 axis_name: str = "data"):
        self.map_fn = map_fn
        self.reduce_fn = reduce_fn
        self.axis_name = axis_name

    def run(self, mesh, *inputs, replicated_inputs: tuple = ()):
        """On ``mesh``: this rank maps its rows of each input's leading
        axis (``replicated_inputs`` passed whole), every rank's result is
        gathered, and the reduced result is returned on every rank."""
        return self._run(mesh_shards(mesh, self.axis_name), inputs, replicated_inputs)

    def run_local(self, n_shards: int, *inputs, replicated_inputs: tuple = ()):
        """Split each input's leading axis into ``n_shards`` equal shards,
        map each shard in order (``replicated_inputs`` passed whole to
        every shard), and reduce."""
        return self._run(local_shards(n_shards), inputs, replicated_inputs)

    def _run(self, shards: Shards, inputs: tuple, replicated_inputs: tuple):
        parts = [shards.split(t) for t in inputs]
        mapped = [
            self.map_fn(*(p[i] for p in parts), *replicated_inputs)
            for i in range(len(shards.held))
        ]
        return self.reduce_fn(shards.gather(mapped))


# ---------------------------------------------------------------------------
# Keyed shuffle (the Hadoop sort/shuffle stage)
# ---------------------------------------------------------------------------

def _send_buckets(values: torch.Tensor, keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """(rows, ...) -> (rows, ...) send buffer: n_shards buckets of
    rows // n_shards rows, bucket d holding the rows keyed to shard d in
    their local order, overflow dropped, short buckets zero-padded."""
    rows = values.shape[0]
    if rows % n_shards != 0:
        raise ValueError(
            f"shuffle_by_key: rows_per_shard={rows} not divisible by n_shards={n_shards}; "
            f"equal send buckets would drop the {rows % n_shards} trailing rows silently. "
            "Pad rows upstream to a multiple of n_shards."
        )
    bucket = rows // n_shards
    dest = keys.to(torch.int64) % n_shards
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    group_start = torch.searchsorted(
        sorted_dest, torch.arange(n_shards, device=dest.device)
    )
    pos = torch.arange(rows, device=dest.device) - group_start[sorted_dest]
    keep = pos < bucket
    send = torch.zeros_like(values)
    send[(sorted_dest * bucket + pos)[keep]] = values[order][keep]
    return send


def shuffle_by_key(values: torch.Tensor, keys: torch.Tensor, mesh_or_group,
                   n_shards: int) -> torch.Tensor:
    """On a mesh (its ``"data"`` dimension) or a process group:
    redistribute this rank's rows so
    that row i lands on shard ``keys[i] % n_shards``, through one
    ``dist.all_to_all_single`` of equal buckets of
    ``rows_per_shard // n_shards`` rows. Returns the (rows_per_shard,
    ...) rows this rank received, source shard by source shard.

    The reference's contract: ``rows_per_shard % n_shards == 0`` or
    ``ValueError``; a shard keying more than a bucket's rows to one
    destination keeps the first ones (stable local order) and drops the
    rest; a short bucket is zero-padded. Under ``gloo`` a CUDA tensor's
    exchange is staged through host memory by the backend.
    """
    group = mesh_or_group
    if hasattr(mesh_or_group, "mesh_dim_names"):
        group = axis_group(mesh_or_group)
    if dist.get_world_size(group) != n_shards:
        raise ValueError(
            f"shuffle_by_key: n_shards={n_shards} but the group has "
            f"{dist.get_world_size(group)} ranks"
        )
    send = _send_buckets(values, keys, n_shards)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def shuffle_by_key_local(values: list, keys: list, n_shards: int) -> list:
    """``shuffle_by_key`` emulated in one process: ``values[s]`` and
    ``keys[s]`` are shard s's rows and keys; returns each shard's
    received rows, in shard order."""
    if len(values) != n_shards or len(keys) != n_shards:
        raise ValueError(f"expected {n_shards} shards of values and keys")
    sends = [_send_buckets(v, k, n_shards) for v, k in zip(values, keys)]
    return [torch.cat([s.chunk(n_shards)[d] for s in sends]) for d in range(n_shards)]


__all__ = [
    "MapReduce",
    "Shards",
    "all_gather_tree",
    "axis_group",
    "local_shards",
    "mesh_shards",
    "reduce_concat",
    "reduce_max",
    "reduce_mean",
    "reduce_sum",
    "shuffle_by_key",
    "shuffle_by_key_local",
]
