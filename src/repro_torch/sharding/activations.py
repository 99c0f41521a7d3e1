"""A mesh Model's activations as DTensors, and the local calls that run
an op on each rank's shard of them.

The mesh Model (``models.model.build(mesh=...)``) keeps its parameters
and activations as DTensors on a ``DeviceMesh`` and lets DTensor's
sharding propagation place the matmuls and elementwise ops, as GSPMD
places the reference's. Three kinds of op do not go through DTensor:

  * the hand-written kernels (K5 attention, K6 SSD), which take plain
    CUDA tensors;
  * ops DTensor has no sharding strategy for (the MoE dispatch's
    ``scatter_add_``, the xLSTM cells' ``logsigmoid``) or that it would
    place expensively (advanced-index gathers);
  * the decode cache's in-place writes.

``ActMesh.local`` runs such an op on local shards: each DTensor argument
is redistributed to the placements its spec declares, the function runs
on the local tensors, and each output is wrapped back as a DTensor with
its declared placements. What the function computes is what it computes
off the mesh; only which rows (batch), heads or experts each rank holds
changes. Nothing here falls back: a redistribution or a kernel launch
that fails raises.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Sequence

import torch

from repro_torch.sharding.rules import mesh_shape, named


def is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


class ActMesh:
    """The mesh, the axes that carry the global batch (``act_axes``), and
    the placements of activations on them."""

    def __init__(self, mesh, act_axes: Sequence[str] | None, seq_shard: bool = False):
        self.mesh = mesh
        self.act_axes = tuple(act_axes) if act_axes is not None else None
        self.seq_shard = seq_shard
        self.shape = mesh_shape(mesh)

    @property
    def tp(self) -> int:
        return self.shape.get("model", 1)

    def batch(self, b: int):
        """The spec entry of a batch dim of size b: the batch axes when
        they divide it over more than one rank, else None (replicated; a
        split over one rank is none, and DTensor cannot flatten a dim of
        size 1 that is "split")."""
        if not self.act_axes:
            return None
        total = math.prod(self.shape[a] for a in self.act_axes)
        return self.act_axes if total > 1 and b % total == 0 else None

    def heads(self, n: int):
        """'model' when n heads (or experts) divide the model axis of more
        than one rank."""
        return "model" if self.tp > 1 and n % self.tp == 0 else None

    def resid(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream (B, S, d) after a block's residual add: rows
        over the batch axes, the sequence over 'model' under ``seq_shard``
        (a reduce-scatter of a row-parallel output), else whole on every
        model rank (an all-reduce), as GSPMD places the reference's. Left
        to itself DTensor keeps the add's partial sums and picks costlier
        layouts for the next matmuls."""
        if not is_dtensor(x):
            return x
        seq = "model" if self.seq_shard and self.tp > 1 and x.shape[1] % self.tp == 0 else None
        return x.redistribute(self.mesh, self.placements((self.batch(x.shape[0]), seq)))

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.mesh.get_local_rank(axis)

    def placements(self, spec):
        """``spec`` as placements (a list of placements passes through)."""
        return spec if isinstance(spec, list) else named(self.mesh, spec)

    def to_local(self, t: Any, spec, split: set[int] = frozenset()) -> Any:
        """t's local shard under ``spec`` (a plain tensor passes through).
        ``split``: the mesh dims over which the local computation is split
        (another input is sharded there). On those dims a replicated
        input's gradient is a partial sum -- each rank's share of the
        computation adds its own part -- and is declared so (the gradient
        would otherwise be taken as whole on every rank)."""
        if not is_dtensor(t):
            return t
        from torch.distributed.tensor import Partial, Replicate

        pl = self.placements(spec)
        grad = [Partial() if i in split and p == Replicate() else p for i, p in enumerate(pl)]
        return t.redistribute(self.mesh, pl).to_local(grad_placements=grad)

    def wrap(self, t: torch.Tensor, spec):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, self.mesh, self.placements(spec), run_check=False)

    def local(self, fn: Callable, args: Sequence[Any], in_specs: Sequence, out_specs):
        """``fn`` on the local shards of ``args`` (each placed by its spec),
        its output(s) wrapped with ``out_specs`` (a spec, a list of
        placements, or a tuple of them for a tuple output; None leaves an
        output as it is)."""
        split = {i for a, s in zip(args, in_specs) if is_dtensor(a)
                 for i, p in enumerate(self.placements(s)) if p.is_shard()}
        out = fn(*(self.to_local(a, s, split) for a, s in zip(args, in_specs)))
        if isinstance(out, tuple):
            return tuple(o if s is None else self.wrap(o, s) for o, s in zip(out, out_specs))
        return self.wrap(out, out_specs)

    def data_parallel(self, fn: Callable, params: Any, *tensors: Any):
        """``fn(params, *tensors)`` with every parameter gathered whole and
        every tensor split over the batch axes along dim 0 only (each rank
        runs the function on its rows; the model axis repeats it). The
        output's tensors (nested in tuples and dicts) come back split
        along dim 0 likewise. The recurrent blocks' path on a mesh."""
        from repro_torch.models import params as pr

        b = next(t for t in tensors if t is not None).shape[0]
        entry = self.batch(b)

        def spec_of(t):
            return (entry,) + (None,) * (t.dim() - 1)

        split = {i for i, p in enumerate(self.placements((entry,))) if p.is_shard()}
        local_params = pr.unflatten((path, self.to_local(t, (), split))
                                    for path, t in pr.flatten(params))
        local = [None if t is None else self.to_local(t, spec_of(t), split) if t.dim() else t
                 for t in tensors]
        return self._wrap_tree(fn(local_params, *local), entry)

    def _wrap_tree(self, out, entry):
        if isinstance(out, torch.Tensor):
            return self.wrap(out, (entry,) + (None,) * (out.dim() - 1))
        if isinstance(out, dict):
            return {k: self._wrap_tree(v, entry) for k, v in out.items()}
        if isinstance(out, (tuple, list)):
            return type(out)(self._wrap_tree(v, entry) for v in out)
        return out


@contextlib.contextmanager
def implicit_replication():
    """DTensor's implicit replication (plain tensors in a DTensor op act as
    replicated DTensors), restoring the previous setting on exit, so that
    it nests: ``torch.distributed.tensor.experimental.implicit_replication``
    turns it off on exit even inside an outer one, which would leave a
    backward that runs after an inner forward without it."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def replication(tree: Any):
    """``implicit_replication`` when the tree's first leaf is a DTensor
    (plain tensors in the ops then act as replicated: the optimizer's 0-dim
    step and rates, the layers' positions and masks and what autograd saved
    of them for the backward); else nothing."""
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    if not is_dtensor(leaf):
        return contextlib.nullcontext()
    return implicit_replication()


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; on DTensors, src is placed as dst is and the
    copy is made between the local shards (in place in dst's storage)."""
    if is_dtensor(dst):
        src = src.redistribute(dst.device_mesh, dst.placements) if is_dtensor(src) else src
        dst.to_local().copy_(src.to_local() if is_dtensor(src) else src)
    else:
        dst.copy_(src)


def full(t: Any) -> Any:
    """The whole tensor of a DTensor (every shard gathered); a plain
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t
