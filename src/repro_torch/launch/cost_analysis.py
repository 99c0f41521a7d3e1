"""Per-device cost of one traced step: the counterpart of the JAX
package's ``launch/hlo_analysis.py``.

PyTorch has no HLO text to read. Instead ``CostMode`` (a
``TorchDispatchMode``) watches one step run op by op and counts, on each
op's LOCAL shapes -- the shard this rank holds after DTensor's sharding
propagation, which is what a device computes and moves:

  * flops            -- every matmul-like op (mm, bmm, addmm, baddbmm,
                        convolutions, fused attentions), by
                        ``torch.utils.flop_counter``'s formulas. Counting a
                        DTensor op itself would count the whole (global)
                        product, so the mode steps aside for DTensor ops
                        (returns ``NotImplemented``) and counts the local
                        ops DTensor runs for them;
  * hbm_bytes        -- the reference's traffic model: each op's output
                        bytes plus its operands' bytes, except ops that move
                        nothing (views, allocations, metadata); slicing
                        gathers charge twice their output (the slice read
                        and written) and in-place writes into a buffer
                        (``index_put_``, ``copy_``, ``scatter``) twice the
                        written source, not the whole buffer;
  * collective_bytes -- per collective type, the reference's link
                        convention: all-reduce 2x input (the reduce-scatter
                        and all-gather phases of a ring), all-gather the
                        output, reduce-scatter the input, all-to-all the
                        input.

Loops. A Python loop (the layers, the microbatches, the chunks of a
chunked scan) still runs its body every trip, and each trip is counted as
it runs. ``models.scan_core.scan``, the twin of ``lax.scan``, runs its
body once under an active mode (``run_trips``): the mode counts that
trip's flops, HBM bytes and collective bytes ``trips`` times, and so the
backward of every autograd node the trip made when the backward runs it.
That is the reference's rule for a while loop with a ``known_trip_count``
(one body, weighted by its trips). The trip's storages count once toward
the peak, as the reference's buffer assignment holds one body's
temporaries.

DTensor's sharding propagation runs each new op once more on fake
tensors of the GLOBAL shapes, to learn its output's shape (on a cache
miss only); the mode skips everything inside that call.

The mode also tracks the step's memory: every storage an op allocates is
live until the storage is freed (a weak reference's callback), which
works on fake tensors, where there is no allocator to ask. ``peak_bytes``
is the largest sum of live storages allocated during the step; storages
of the arguments (``exclude``) are not counted.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
# Ops that move no bytes of HBM: allocations, metadata, the collectives'
# waits.
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "alias", "lift_fresh", "wait_tensor", "_local_scalar_dense",
               "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "size", "stride"}
# Reads of a slice of a larger operand: charged 2 x their output.
_SLICING = {"index", "gather", "embedding", "index_select", "slice", "select",
            "take_along_dim"}
# In-place writes of a source into a buffer: charged 2 x the source.
_WRITES = {"index_put_", "index_put", "copy_", "scatter_", "scatter", "scatter_add_",
           "scatter_add", "slice_scatter", "select_scatter", "_index_put_impl_"}


# Metadata ops that the fake tensors ask for all the time: no cost, no
# storage.
_METADATA = {torch.ops.prim.device.default, torch.ops.aten.sym_size.int,
             torch.ops.aten.sym_stride.int, torch.ops.aten.sym_numel.default}


@dataclasses.dataclass
class StepCost:
    """Per-device cost of one step (the reference's ``HloCost``)."""
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_by_type: dict


def _tensors(tree: Any) -> list[torch.Tensor]:
    """The tensors in an op's arguments or outputs (lists, tuples, dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out: list[torch.Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int | None:
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def local_bytes(tree: Any) -> int:
    """Bytes of a tree's distinct storages on this rank (a DTensor's local
    shard)."""
    from repro_torch.sharding.activations import is_dtensor

    seen, total = set(), 0
    for t in _tensors(tree):
        t = t.to_local() if is_dtensor(t) else t
        key = _storage_key(t)
        if key in seen:
            continue
        seen.add(key)
        total += t.untyped_storage().nbytes() if key is not None else _nbytes(t)
    return total


class CostMode(TorchDispatchMode):
    """Counts a step's flops, HBM bytes, collective bytes and live
    storages on local shapes (see the module docstring). ``exclude``: a
    tree of tensors (the step's arguments) whose storages are not the
    step's own."""

    def __init__(self, exclude: Any = ()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops_of = flop_registry
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_by_type: dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self.propagations = 0   # DTensor shape propagations seen (and not counted)
        self._weight = 1        # trips each counted op stands for (``run_trips``)
        self._tracked: dict[int, tuple[weakref.ref, int]] = {}
        from repro_torch.sharding.activations import is_dtensor

        self._known = {_storage_key(t.to_local() if is_dtensor(t) else t)
                       for t in _tensors(exclude)}

    # --- DTensor's shape propagation is not the step's work ----------------
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        # DTensor's sharding propagation runs each op on global-shaped fake
        # tensors through this method; the ops it runs there are not counted.
        if not hasattr(ShardingPropagator, "_propagate_tensor_meta_non_cached"):
            raise RuntimeError(
                "this torch's ShardingPropagator has no _propagate_tensor_meta_non_cached: "
                "CostMode cannot tell DTensor's global-shape propagation from the step's ops")
        self._skip = 0
        self._patched = ShardingPropagator._propagate_tensor_meta_non_cached
        patched, mode = self._patched, self

        def propagate(prop, *args, **kwargs):
            mode._skip += 1
            mode.propagations += 1
            try:
                return patched(prop, *args, **kwargs)
            finally:
                mode._skip -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        ShardingPropagator._propagate_tensor_meta_non_cached = self._patched
        return super().__exit__(*exc)

    # --- memory -------------------------------------------------------------
    def _track(self, out: Any) -> None:
        for t in _tensors(out):
            key = _storage_key(t)
            if key is None or key in self._known or key in self._tracked:
                continue
            st = t.untyped_storage()
            n = st.nbytes()
            self._tracked[key] = (weakref.ref(st, self._freed(key, n)), n)
            self.live += n
        self.peak = max(self.peak, self.live)

    def _freed(self, key: int, n: int):
        def callback(_):
            if self._tracked.pop(key, None) is not None:
                self.live -= n
        return callback

    # --- loops run once for all their trips (``scan_core.scan``) -------------
    def _sequence_mark(self) -> int:
        """The sequence number the next autograd node will get (nodes are
        numbered in creation order, per thread)."""
        self._skip += 1
        try:
            with torch.enable_grad():
                probe = torch.empty(0, requires_grad=True).view(0)
            return probe.grad_fn._sequence_nr() + 1
        finally:
            self._skip -= 1

    def _weight_backward(self, out: Any, since: int, trips: int) -> None:
        """Weight the backward of every autograd node behind ``out`` that
        was made at or after ``since`` by ``trips``: a pre-hook raises the
        weight as the engine starts the node, a hook puts it back."""
        seen: set[int] = set()
        stack = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
        while stack:
            node = stack.pop()
            if node is None or id(node) in seen:
                continue
            seen.add(id(node))
            if type(node).__name__ == "AccumulateGrad" or node._sequence_nr() < since:
                continue
            saved: list[int] = []

            def pre(grads, saved=saved):
                saved.append(self._weight)
                self._weight *= trips

            def post(grad_inputs, grad_outputs, saved=saved):
                self._weight = saved.pop()

            node.register_prehook(pre)
            node.register_hook(post)
            stack.extend(nxt for nxt, _ in node.next_functions)

    def run_trips(self, fn: Callable[[], Any], trips: int) -> Any:
        """``fn()``, one trip of a loop body, counted as ``trips`` trips:
        its ops now, its autograd nodes' backward when it runs."""
        since = self._sequence_mark() if torch.is_grad_enabled() else None
        before = self._weight
        self._weight = before * trips
        try:
            out = fn()
        finally:
            self._weight = before
        if since is not None:
            self._weight_backward(out, since, trips)
        return out

    # --- dispatch -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._skip or func in _METADATA:
            return out
        self._count(func, args, kwargs, out)
        self._track(out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = packet.__name__
        ns = packet._qualified_op_name.split("::")[0]
        w = self._weight
        if packet in self._flops_of:
            self.flops += w * float(self._flops_of[packet](*args, **kwargs, out_val=out))
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_bytes = sum(_nbytes(t) for t in ins)
        out_bytes = sum(_nbytes(t) for t in outs)
        if ns in ("_c10d_functional", "c10d", "c10d_functional") and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            first = _nbytes(ins[0]) if ins else 0
            moved = {"all-reduce": 2 * first, "all-gather": out_bytes}.get(kind, first)
            self.coll_by_type[kind] = self.coll_by_type.get(kind, 0.0) + w * moved
            self.hbm_bytes += w * (in_bytes + out_bytes)
            return
        if not outs or ns == "prim" or name in _NO_TRAFFIC or func.is_view:
            return  # metadata (no tensor out), allocations, views
        if name in _SLICING:
            self.hbm_bytes += w * 2 * out_bytes
        elif name in _WRITES:
            src = [t for t in ins[1:] if t.dtype.is_floating_point or t.dtype == ins[0].dtype]
            self.hbm_bytes += w * 2 * (_nbytes(src[-1]) if src else out_bytes)
        else:
            self.hbm_bytes += w * (in_bytes + out_bytes)

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll_by_type.values()))

    def cost(self) -> StepCost:
        return StepCost(self.flops, self.hbm_bytes, self.coll_bytes, dict(self.coll_by_type))


def roofline_terms(cost: StepCost, *, peak_flops: float, hbm_bw: float,
                   ici_bw: float) -> dict:
    compute_s = cost.flops / peak_flops
    memory_s = cost.hbm_bytes / hbm_bw
    collective_s = cost.coll_bytes / ici_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).removesuffix("_s")
    return terms
