"""Sharding rules (twin of the JAX package's ``sharding/rules.py``): map
every parameter, batch and cache leaf to a partition spec on the
production mesh, and place trees by those specs as DTensors.

A partition spec here is a tuple with one entry per leading tensor dim
(trailing dims may be left out, as in ``jax.sharding.PartitionSpec``):
``None`` (replicated), an axis name, or a tuple of axis names that
split the same dim in mesh order. The rules return the reference's specs
entry for entry, so they compare one for one with the JAX package.

Logical axes:
  * ``batch``  -> ("pod", "data") on the multi-pod mesh, ("data",) single-pod;
  * ``fsdp``   -> "data"  (ZeRO-style parameter sharding within a pod;
                  parameters replicated across pods);
  * ``tp``     -> "model" (tensor / expert / head parallelism);
  * ``seq``    -> "data"  (batch 1: the KV-cache sequence is sharded).

Every assignment is guarded by divisibility: a dim that does not divide by
its mesh axis size falls back to replication (e.g. paligemma's 8 heads on
a 16-way model axis shard the flattened q dim instead of the head axis).
Rules are name-based over the tree paths, so they apply to every arch,
stacked-layer axes included (stack axes are never sharded).

The rules need only the mesh's axis names and sizes: ``mesh`` is a
``DeviceMesh`` or a mapping of axis name to size in mesh order, so they
run without a process group. ``named`` turns a spec into DTensor
placements on a ``DeviceMesh`` and ``distribute`` places a tree.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

# (repro_torch.models imports this package: the tree helpers of
# models.params are imported where they are used.)

from repro_torch.configs.base import ArchConfig

Spec = tuple

# parameter-name -> (row_logical, col_logical) for the trailing two dims;
# 1-D params are replicated unless listed in the vector rules.
_MATRIX_RULES: dict[str, tuple[str | None, str | None]] = {
    "embed": ("tp", None),          # big vocab sharded over model
    "unembed": ("fsdp", "tp"),
    "frontend_proj": (None, "fsdp"),
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "wi": ("fsdp", "tp"),
    "wi_gate": ("fsdp", "tp"),
    "wi_up": ("fsdp", "tp"),
    "in_proj": ("fsdp", "tp"),
    "out_proj": ("tp", "fsdp"),
    "up_proj": ("fsdp", "tp"),
    "down_proj": ("tp", "fsdp"),
    "router": ("fsdp", None),
    "w_igate": ("fsdp", None),
    "w_fgate": ("fsdp", None),
    "ffn_wi": ("fsdp", "tp"),
    "ffn_wo": ("tp", "fsdp"),
    "w": ("fsdp", "tp"),            # slstm gate input weights
    "r": (None, None),              # slstm recurrent (H, P, P): replicated
}

# MoE expert tensors (E, d, f): E -> tp (expert parallel), d/f -> fsdp.
_EXPERT_PARAMS = {"wi_gate", "wi_up", "wo"}

STRATEGIES = ("2d", "fsdp", "dp", "dp_vocab")


def mesh_shape(mesh: Any) -> dict[str, int]:
    """Axis name -> size, in mesh order, of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(shape: dict[str, int], strategy: str = "2d") -> dict:
    """Sharding strategies:

    * "2d"   -- batch over (pod, data); params FSDP over data + TP over
                model.  The default; right for big models.
    * "fsdp" -- batch AND params over (pod?, data, model) flattened: pure
                ZeRO-3, no tensor parallelism.
    * "dp"   -- batch over every axis, params replicated (classic data
                parallel; the paper's own MapReduce layout).
    * "dp_vocab" -- data-parallel blocks with the vocab-sized embed,
                unembed and logits still tensor-sharded over 'model'.
    """
    dp = tuple(n for n in shape if n in ("pod", "data"))
    if strategy == "2d":
        return {"batch": dp, "fsdp": "data", "tp": "model"}
    allax = dp + ("model",)
    if strategy == "fsdp":
        return {"batch": allax, "fsdp": ("data", "model"), "tp": None}
    if strategy == "dp":
        return {"batch": allax, "fsdp": None, "tp": None}
    if strategy == "dp_vocab":
        return {"batch": dp, "fsdp": None, "tp": "model"}
    raise ValueError(strategy)


def _axis_size(shape: dict[str, int], ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= shape[a]
        return n
    return shape[ax]


def _fits(dim: int, shape: dict[str, int], logical, axes) -> bool:
    ax = axes.get(logical) if isinstance(logical, str) else logical
    return dim % _axis_size(shape, ax) == 0


def _resolve(logical, axes):
    if logical is None:
        return None
    return axes[logical]


def _spec(entries) -> Spec:
    """A spec with ``PartitionSpec``'s normal form: a one-name tuple entry
    is the bare name, an empty one None."""
    def norm(e):
        if isinstance(e, tuple):
            return None if not e else (e[0] if len(e) == 1 else e)
        return e
    return tuple(norm(e) for e in entries)


def _map_with_path(fn, tree: dict) -> dict:
    from repro_torch.models import params as pr

    return pr.unflatten((path, _spec(fn(path, leaf))) for path, leaf in pr.flatten(tree))


def param_pspecs(cfg: ArchConfig, mesh: Any, param_shapes: Any,
                 strategy: str = "2d", align_heads: bool = True) -> Any:
    """Tree of specs matching ``param_shapes`` (tensors or TensorSpecs).

    ``align_heads`` (default on): only tensor-shard attention projections
    when the HEAD COUNT divides the tp axis; sharding the flattened q dim
    with a non-dividing head count re-partitions at the (B,S,H,hd)
    reshape."""
    shape_of = mesh_shape(mesh)
    axes = _axes(shape_of, strategy)
    tp_size = _axis_size(shape_of, axes["tp"])

    def fits(dim, logical):
        return _fits(dim, shape_of, logical, axes)

    def rule(path, leaf) -> Spec:
        name = path[-1]
        shape = tuple(leaf.shape)
        inside_moe = "moe" in path
        if strategy == "dp_vocab" and name not in ("embed", "unembed"):
            return ()
        if align_heads and tp_size > 1:
            def fsdp_only(row: bool) -> Spec:
                ax = _resolve("fsdp", axes) if fits(shape[-2 if row else -1], "fsdp") else None
                return tuple([None] * (len(shape) - 2) + ([ax, None] if row else [None, ax]))
            if name == "wq" and cfg.n_heads % tp_size:
                return fsdp_only(row=True)
            if name in ("wk", "wv") and cfg.n_kv_heads % tp_size:
                return fsdp_only(row=True)
            if name in ("bq",) and cfg.n_heads % tp_size:
                return ()
            if name in ("bk", "bv") and cfg.n_kv_heads % tp_size:
                return ()
            if name == "wo" and cfg.n_heads % tp_size:
                return fsdp_only(row=False)
        if name in _MATRIX_RULES and len(shape) >= 2:
            if inside_moe and name in _EXPERT_PARAMS and len(shape) >= 3:
                # (stack..., E, d, f): expert axis -> tp (expert parallel);
                # if E does not divide tp, tensor parallelism WITHIN each
                # expert: shard the FFN dim over tp.
                e_dim, r_dim, c_dim = shape[-3], shape[-2], shape[-1]
                if fits(e_dim, "tp") and axes["tp"]:
                    e_ax, r_ax, c_ax = "tp", ("fsdp" if fits(r_dim, "fsdp") else None), None
                else:
                    e_ax = None
                    if name in ("wi_gate", "wi_up"):
                        r_ax = "fsdp" if fits(r_dim, "fsdp") else None
                        c_ax = "tp" if fits(c_dim, "tp") else None
                    else:  # wo: (E, f, d)
                        r_ax = "tp" if fits(r_dim, "tp") else None
                        c_ax = "fsdp" if fits(c_dim, "fsdp") else None
                return tuple([None] * (len(shape) - 3) + [
                    _resolve(e_ax, axes), _resolve(r_ax, axes), _resolve(c_ax, axes)])
            row_l, col_l = _MATRIX_RULES[name]
            if not fits(shape[-2], row_l):
                row_l = None
            if not fits(shape[-1], col_l):
                col_l = None
            if row_l and col_l and axes[row_l] == axes[col_l]:
                col_l = None  # never the same axis twice
            return tuple([None] * (len(shape) - 2) + [_resolve(row_l, axes),
                                                       _resolve(col_l, axes)])
        # vectors & norms: biases of sharded matmuls stay aligned with outputs
        if name in ("bq", "bk", "bv", "bi", "conv_b") and len(shape) >= 1 \
                and fits(shape[-1], "tp"):
            return tuple([None] * (len(shape) - 1) + ["model"])
        return ()

    return _map_with_path(rule, param_shapes)


def batch_pspecs(cfg: ArchConfig, mesh: Any, batch: Any, strategy: str = "2d") -> Any:
    """Leading (global batch) axis over the strategy's batch axes."""
    shape_of = mesh_shape(mesh)
    axes = _axes(shape_of, strategy)
    batch_ax = axes["batch"]

    def rule(path, leaf) -> Spec:
        nd = len(leaf.shape)
        b = leaf.shape[0]
        if _fits(b, shape_of, batch_ax, axes):
            return (batch_ax,) + (None,) * (nd - 1)
        if len(batch_ax) > 1 and _fits(b, shape_of, ("data",), axes):
            return ("data",) + (None,) * (nd - 1)
        return (None,) * nd

    return _map_with_path(rule, batch)


def _batch_axis(shape_of: dict, axes: dict, batch_size: int):
    if _fits(batch_size, shape_of, axes["batch"], axes):
        return axes["batch"]
    if _fits(batch_size, shape_of, ("data",), axes):
        return ("data",)
    return None


def logits_pspec(cfg: ArchConfig, mesh: Any, batch_size: int, strategy: str = "2d") -> Spec:
    shape_of = mesh_shape(mesh)
    axes = _axes(shape_of, strategy)
    v_ax = "model" if _fits(cfg.vocab_size, shape_of, "tp", axes) else None
    return _spec((_batch_axis(shape_of, axes, batch_size), None, v_ax))


def cache_pspecs(cfg: ArchConfig, mesh: Any, cache_shapes: Any, batch_size: int,
                 strategy: str = "2d") -> Any:
    """Decode caches. Batch over ('pod','data') when divisible; heads /
    hidden over 'model' when divisible; batch=1 long-context shards the
    KV sequence dim over 'data' instead (sequence parallelism)."""
    shape_of = mesh_shape(mesh)
    axes = _axes(shape_of, strategy)
    batch_ax = _batch_axis(shape_of, axes, batch_size)
    seq_parallel = batch_ax is None   # batch=1 (long_500k)

    def fits_tp(dim):
        return _fits(dim, shape_of, "tp", axes)

    def rule(path, leaf) -> Spec:
        name = path[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec: list = [None] * nd
        if name in ("k", "v"):
            # (sites?, L?, B, S, K, hd)
            spec[nd - 4] = batch_ax
            seq_axes = ["data"] if seq_parallel else []
            if fits_tp(shape[nd - 2]) and axes["tp"]:
                spec[nd - 2] = "model"
            else:
                # few KV heads (GQA/MQA): shard the cache SEQUENCE over
                # 'model' instead -- attention reduces over S.
                seq_axes.append("model")
            total = 1
            for a in seq_axes:
                total *= shape_of[a]
            if seq_axes and shape[nd - 3] % total == 0:
                spec[nd - 3] = tuple(seq_axes) if len(seq_axes) > 1 else seq_axes[0]
            return tuple(spec)
        if name == "state":
            # mamba: (..., B, H, N, Pd) / mlstm: (..., B, H, Pd, Pd+1)
            spec[nd - 4] = batch_ax
            if fits_tp(shape[nd - 3]):
                spec[nd - 3] = "model"     # heads
            elif fits_tp(shape[nd - 2]):
                spec[nd - 2] = "model"     # xlstm: few heads, shard Dk
            return tuple(spec)
        if name == "conv":
            # (..., B, W-1, conv_dim)
            spec[nd - 3] = batch_ax
            if fits_tp(shape[nd - 1]):
                spec[nd - 1] = "model"
            return tuple(spec)
        if name in ("c", "n", "h"):
            # slstm states (..., B, H, Pd)
            spec[nd - 3] = batch_ax
            if fits_tp(shape[nd - 1]):
                spec[nd - 1] = "model"
            return tuple(spec)
        return ()  # pos etc.

    return _map_with_path(rule, cache_shapes)


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------

def named(mesh, spec: Spec) -> list:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    ``Shard(d)`` on every mesh dim named in dim d's entry, ``Replicate()``
    elsewhere. A tuple entry such as ("pod", "data") shards one tensor dim
    over two mesh dims, in mesh order (as GSPMD splits it: the first axis
    is the major one)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes {group} of dim {d} are not in mesh "
                             f"order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} is used twice")
            out[i] = Shard(d)
    return out


def place(t: torch.Tensor, mesh, spec: Spec):
    """One tensor as a DTensor on ``mesh`` placed by ``spec``. ``t`` is the
    whole (global) tensor, the same on every rank: each rank keeps its own
    slice, with no communication. A DTensor is redistributed instead."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        return t.redistribute(mesh, named(mesh, spec))
    if t.device.type != mesh.device_type:
        raise ValueError(f"a {tuple(t.shape)} tensor on {t.device} cannot be placed on a "
                         f"{mesh.device_type} mesh")
    return distribute_tensor(t, mesh, named(mesh, spec), src_data_rank=None)


def distribute(tree: Any, mesh, specs: Any) -> Any:
    """A parameter, batch or cache tree (nested dicts of tensors) placed
    leaf by leaf by the matching tree of specs (``param_pspecs``,
    ``batch_pspecs``, ``cache_pspecs``)."""
    from repro_torch.models import params as pr

    spec_of = dict(pr.flatten(specs))
    return pr.unflatten((path, place(t, mesh, spec_of[path])) for path, t in pr.flatten(tree))
