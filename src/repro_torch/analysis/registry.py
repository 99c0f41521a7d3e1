"""Registry of the port's hot entry points, at pinned shapes.

The twin of ``repro.analysis.registry``: every function on the serving
or training hot path is registered here, under the reference's name, with
its arguments as ``TensorSpec`` trees (the analogue of
``jax.ShapeDtypeStruct``) and its declared invariants:

  * which arguments carry state that the entry must update in place
    (``must_alias``: the storage a captured CUDA graph of the step reads
    and writes);
  * which argument is carried state whose outputs must keep its shape,
    dtype and device (``carry``).

``contracts`` runs each entry under fake tensors (nothing is computed);
every registered entry runs that way, none needs real tensors. Entries
run on the CPU device, so the kernel ops take their plain versions: the
CUDA wrappers launch hand-written kernels that no fake tensor can enter,
and their own shape checks (``kernels/*/kernel.py``) stand where the
reference's BlockSpec rules stood. Adding a hot path to the port means
adding an ``EntrySpec`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor argument's shape and dtype (a fake tensor when the entry
    runs)."""

    shape: tuple
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class GeneratorSpec:
    """A ``torch.Generator`` argument, seeded when the entry runs."""

    seed: int = 0


@dataclasses.dataclass(frozen=True)
class EntrySpec:
    """One registered hot entry point at pinned shapes.

    name          : the reference's entry name, used in reports and
                    suppressions.
    fn            : the shipped callable.
    args          : positional arguments: trees (tuples, named tuples,
                    lists, dicts) of ``TensorSpec`` / ``GeneratorSpec``
                    and plain Python values.
    static_kwargs : keyword arguments passed as they are.
    must_alias    : argnums whose tensors the entry must update in place.
    carry         : (argnum, out_index) of carried state whose outputs
                    must keep the inputs' shape, dtype and device;
                    out_index None means the whole output (an entry that
                    returns None carries its argument in place).
    description   : one line for the report.
    """

    name: str
    fn: Callable
    args: tuple
    static_kwargs: dict = dataclasses.field(default_factory=dict)
    must_alias: tuple = ()
    carry: tuple | None = None
    description: str = ""


def _spec(*shape, dtype=torch.float32) -> TensorSpec:
    return TensorSpec(tuple(shape), dtype)


# ---------------------------------------------------------------------------
# Pinned shapes: the reference's. Small batch and tree counts, the REAL
# window and channel geometry.
# ---------------------------------------------------------------------------

B = 2          # engine slots
D = 2          # replay depth
N_SHARDS = 2   # MapReduce shards
CPU = torch.device("cpu")


def _pinned_cfg(overlap: int = 0):
    from repro_torch.core import rotation_forest as rf
    from repro_torch.signal import pipeline

    return pipeline.PipelineConfig(
        forest=rf.RotationForestConfig(n_trees=4, n_subsets=3, depth=4, n_classes=2, n_bins=8),
        overlap=overlap,
    )


def _geometry(cfg):
    from repro_torch.signal import eeg_data, features

    c, n, w = eeg_data.N_CHANNELS, eeg_data.WINDOW, eeg_data.WINDOWS_PER_MATRIX
    f_raw = features.feature_dim(c, cfg.wpd_level)
    k = cfg.forest.n_subsets
    f_pad = f_raw + (-f_raw % k)
    n_leaves = 2 ** cfg.forest.depth
    return c, n, w, f_raw, f_pad, n_leaves


def _packed_specs(cfg):
    """The program's packed forest, with the walk tables every installed
    program carries."""
    from repro_torch.kernels.forest import ops as forest_ops

    _, _, _, _, f_pad, n_leaves = _geometry(cfg)
    t, nc = cfg.forest.n_trees, cfg.forest.n_classes
    return forest_ops.PackedForest(
        proj=_spec(t, f_pad, n_leaves), thr=_spec(t, n_leaves),
        leaf_probs=_spec(t, n_leaves, nc), proj_nodes=_spec(t, n_leaves, f_pad),
        next_node=_spec(t, n_leaves, 2, dtype=torch.int32),
    )


def _engine_state_specs(cfg):
    from repro_torch.serving import api
    from repro_torch.signal import eeg_data, frontend

    c, n = eeg_data.N_CHANNELS, eeg_data.WINDOW
    i32 = torch.int32
    return api.EngineState(
        rings=_spec(B, cfg.alarm_m, dtype=i32), ring_pos=_spec(B, dtype=i32),
        alarm=_spec(B, dtype=i32), fe_boundary=_spec(B, frontend.boundary_width(cfg.overlap), c, n),
        fe_phase=_spec(B, dtype=i32),
    )


# ---------------------------------------------------------------------------
# Entry builders (deferred imports: importing this module stays cheap).
# ---------------------------------------------------------------------------

def _serving_entries():
    from repro_torch.serving import api

    cfg = _pinned_cfg()
    c, n, w, f_raw, _, _ = _geometry(cfg)
    state = _engine_state_specs(cfg)
    packed = _packed_specs(cfg)
    mean, std = _spec(f_raw), _spec(f_raw)
    step_args = (state, _spec(B, D, w, c, n), _spec(B, D, dtype=torch.int32), packed, mean, std)
    yield EntrySpec(
        name="serving.engine_step", fn=api._engine_step, args=step_args,
        static_kwargs=dict(cfg=cfg), must_alias=(0,), carry=(0, 0),
        description="serial engine step: frontend_step per backlog chunk + forest vote "
                    "+ alarm rings",
    )
    yield EntrySpec(
        name="serving.engine_step_megabatch", fn=api._engine_step_megabatch, args=step_args,
        static_kwargs=dict(cfg=cfg), must_alias=(0,), carry=(0, 0),
        description="megabatch engine step (engine default): (B*D) batched "
                    "denoise+WPD+vote, thin alarm-ring loop",
    )
    yield EntrySpec(
        name="serving.score_chunks", fn=api._score_chunks,
        args=(_spec(B, w, c, n), packed, mean, std), static_kwargs=dict(cfg=cfg),
        description="stateless chunk scoring (denoise+WPD+vote)",
    )
    yield EntrySpec(
        name="serving.splice_state", fn=api._splice_state,
        args=(state, 0, _spec(cfg.alarm_m, dtype=torch.int32), 0, 0,
              _spec(state.fe_boundary.shape[1], c, n), 0),
        must_alias=(0,), carry=(0, None),
        description="session admit: splice saved stream state into a slot, in place",
    )
    yield EntrySpec(
        name="serving.init_state", fn=api.init_state, args=(),
        static_kwargs=dict(max_batch=B, alarm_m=cfg.alarm_m, device=CPU),
        description="zero engine state made on its device",
    )
    yield EntrySpec(
        name="serving.engine_restore", fn=api._install_state, args=(state,),
        static_kwargs=dict(device=CPU), carry=(0, None),
        description="snapshot-restore state install: restored leaves cast and "
                    "placed as the step takes them",
    )
    yield EntrySpec(
        name="serving.engine_swap_program", fn=api._install_program_arrays,
        args=(packed, mean, std), static_kwargs=dict(device=CPU), carry=(0, 0),
        description="live program hot-swap install: the same shapes, types and "
                    "device as the serving program",
    )


def _signal_entries():
    from repro_torch.signal import eeg_data, frontend

    c, n, w = eeg_data.N_CHANNELS, eeg_data.WINDOW, eeg_data.WINDOWS_PER_MATRIX
    for overlap in (0, 2):
        st = frontend.FrontendState(
            boundary=_spec(frontend.boundary_width(overlap), c, n),
            phase=_spec(dtype=torch.int32),
        )
        yield EntrySpec(
            name=f"signal.frontend_step{f'_overlap{overlap}' if overlap else ''}",
            fn=frontend.frontend_step, args=(st, _spec(w, c, n)),
            static_kwargs=dict(cfg=_pinned_cfg(overlap)), carry=(0, 0),
            description="streaming front-end transition (denoise + WPD)",
        )
    st = frontend.FrontendState(boundary=_spec(1, c, n), phase=_spec(dtype=torch.int32))
    yield EntrySpec(
        name="signal.process_windows_scan", fn=frontend.scan_stream,
        args=(st, _spec(3, w, c, n)), static_kwargs=dict(cfg=_pinned_cfg()), carry=(0, 0),
        description="chunk-aligned stream scan of frontend_step",
    )


def _training_entries():
    from repro_torch.core import decision_tree, forest_trainer

    cfg = _pinned_cfg()
    t, n_rows, f = cfg.forest.n_trees, 64, 9
    yield EntrySpec(
        name="core.fit_forest_binned", fn=decision_tree.fit_forest_binned,
        args=(_spec(t, n_rows, f, dtype=torch.int32), _spec(n_rows, dtype=torch.int32),
              _spec(t, n_rows)),
        static_kwargs=dict(depth=cfg.forest.depth, n_classes=cfg.forest.n_classes,
                           n_bins=cfg.forest.n_bins),
        description="level-synchronous fused forest grower",
    )
    yield EntrySpec(
        name="core.fit_mapreduce_map", fn=forest_trainer.fit_mapreduce,
        args=(GeneratorSpec(0), _spec(n_rows, f), _spec(n_rows, dtype=torch.int32), cfg.forest),
        static_kwargs=dict(n_shards=N_SHARDS),
        description="MapReduce shard fit (global moments + union reduce), emulated shards",
    )


def _kernel_entries():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.forest import ops as forest_ops
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.histogram import ops as hist_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.wpd import ops as wpd_ops
    from repro_torch.signal import eeg_data, wavelet

    cfg = _pinned_cfg()
    _, _, _, f_raw, _, _ = _geometry(cfg)
    yield EntrySpec(
        name="kernels.forest.forest_predict_proba", fn=forest_ops.forest_predict_proba,
        args=(_packed_specs(cfg), _spec(16, f_raw)),
        description="packed-forest traversal (K1's router)",
    )
    t, n_rows, f, nc = 2, 64, 9, cfg.forest.n_classes
    yield EntrySpec(
        name="kernels.histogram.class_histogram", fn=hist_ops.class_histogram,
        args=(_spec(t, n_rows, f, dtype=torch.int32), _spec(t, n_rows, nc), 16),
        description="grower class histogram (K4's router, the TPU kernel's contract)",
    )
    yield EntrySpec(
        name="kernels.gram.gram", fn=gram_ops.gram, args=(_spec(256, 128),),
        description="X^T X (MSPCA covariance stage, K3's router)",
    )
    h, g = wavelet.filters("db4")
    yield EntrySpec(
        name="kernels.wpd.wpd_level", fn=wpd_ops.wpd_level,
        args=(_spec(16, eeg_data.WINDOW), h, g),
        description="one wavelet analysis level (K2's router)",
    )
    yield EntrySpec(
        name="kernels.ssd.ssd_scan", fn=ssd_ops.ssd_scan,
        args=(_spec(2, 32, 128), _spec(2, 32, 128), _spec(2, 32, 128), _spec(2, 32)),
        static_kwargs=dict(chunk=16),
        description="SSD two-pass chunked scan (K6's router, models stack)",
    )
    yield EntrySpec(
        name="kernels.flash_attention.flash_attention", fn=flash_ops.flash_attention,
        args=(_spec(1, 32, 2, 128), _spec(1, 32, 1, 128), _spec(1, 32, 1, 128)),
        description="flash attention (K5's router, models stack)",
    )


def build_registry() -> list[EntrySpec]:
    """Every registered entry, in a fixed order."""
    entries: list[EntrySpec] = []
    for gen in (_serving_entries, _signal_entries, _training_entries, _kernel_entries):
        entries.extend(gen())
    names = [e.name for e in entries]
    assert len(names) == len(set(names)), "duplicate entry names"
    return entries


def entry_roots(entries: list[EntrySpec] | None = None) -> set[tuple[str, str]]:
    """(dotted module, function name) of every registered entry's function:
    the roots of ``lint``'s reachability."""
    out = set()
    for e in entries if entries is not None else build_registry():
        fn: Any = e.fn
        out.add((fn.__module__, fn.__name__))
    return out
