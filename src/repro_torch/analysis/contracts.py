"""Contract rules for the registered hot entry points, in torch terms.

Each registered ``EntrySpec`` (``registry``) runs once at its pinned
shapes under ``FakeTensorMode`` (meta tensors: shapes, dtypes and
devices flow, nothing is computed), the torch analogue of tracing. A
``TorchFunctionMode`` records every host read of a fake tensor on the
way, and the rules in ``RULES`` read the run. The reference's rules map
so:

  host-sync       (``host-callback``, ``trace-transfer``) the entry runs
                  without a data-dependent host read: ``.item()``,
                  ``.tolist()``, ``.cpu()``, ``.numpy()``, a tensor's
                  ``bool``/``int``/``float``, ``nonzero`` and boolean-mask
                  indexing (fake tensors refuse the last ones outright).
                  Each is a device-to-host sync on the card.
  state-in-place  (``donation-declared``, ``donation-surviving``) an entry
                  that declares ``must_alias`` returns its carried state
                  in the storage it was given (or updates it in place and
                  returns None): the condition for a captured CUDA graph
                  of the step.
  float64-leak    no float64 output. (Torch has no weak types: the
                  reference's weak-type half has no counterpart.)
  carry-stable    carried outputs keep their inputs' shape, dtype and
                  device exactly.

``pallas-tile-divides`` and ``pallas-narrow-output-tile`` have no
counterpart: the port has no BlockSpecs. Each CUDA wrapper in
``kernels/*/kernel.py`` checks its own shapes, types and layout before it
launches, and ``chip_smoke.py`` holds every kernel against its plain
version at the main path's shapes.

Every entry runs on the CPU device, so the kernel ops route to their
plain versions: what is checked is the code around the kernels, which is
the same on the card.

``host-sync`` therefore cannot see a sync that happens only on the card:
cuSOLVER's ``torch.linalg.eigh`` checks its info on the host (6 syncs a
warm engine step, at ``core/pca.py``), and a host-to-device copy from
pageable memory (the batch and mask that ``SeizureEngine._step_once``
sends each step, outside the entry) waits for the copy. A clean entry
here is not yet a capturable one. The lint's ``host-sync-in-entry``
names the ``torch.linalg`` calls that sync on the card;
``sanitizers.guard_methods`` counts every sync of a running step on the
card, and its count is the one that decides.
"""

from __future__ import annotations

import dataclasses
import os
import traceback
from typing import Any

import torch
from torch._subclasses.fake_tensor import (
    DataDependentOutputException,
    DynamicOutputShapeException,
    FakeTensor,
    FakeTensorMode,
    unset_fake_temporarily,
)
from torch.overrides import TorchFunctionMode

from repro_torch.analysis.base import Violation
from repro_torch.analysis.registry import EntrySpec, GeneratorSpec, TensorSpec

# Tensor methods that read a tensor's values on the host.
_HOST_READS = {
    torch.Tensor.item: ".item()",
    torch.Tensor.tolist: ".tolist()",
    torch.Tensor.cpu: ".cpu()",
    torch.Tensor.numpy: ".numpy()",
    torch.Tensor.__bool__: "bool(tensor)",
    torch.Tensor.__int__: "int(tensor)",
    torch.Tensor.__float__: "float(tensor)",
    torch.Tensor.__index__: "tensor as an index",
    torch.Tensor.nonzero: ".nonzero()",
    torch.nonzero: "torch.nonzero",
}
# Reads a fake tensor cannot answer: the recorder stops the run there.
_FATAL_UNDER_FAKE = {".item()", ".tolist()", ".numpy()", "bool(tensor)", "int(tensor)",
                     "float(tensor)", "tensor as an index"}
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # src/repro_torch
_ANALYSIS = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_PACKAGE))


class HostRead(Exception):
    """Raised by the recorder at a host read a fake tensor cannot answer."""


def _site(frames) -> str:
    """``path:line`` of the innermost frame in the port outside this
    package (else the innermost frame)."""
    inside = [f for f in frames if os.path.abspath(f.filename).startswith(_PACKAGE)
              and not os.path.abspath(f.filename).startswith(_ANALYSIS)]
    f = (inside or list(frames) or [None])[-1]
    if f is None:
        return "?"
    return f"{os.path.relpath(os.path.abspath(f.filename), _ROOT)}:{f.lineno}"


class _HostReadRecorder(TorchFunctionMode):
    """Records each host read of a fake tensor and where it happens, and
    stops the run at a read that has no fake answer."""

    def __init__(self):
        super().__init__()
        self.reads: list[tuple[str, str]] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        what = _HOST_READS.get(func)
        if what is None:
            return func(*args, **(kwargs or {}))
        if not any(isinstance(a, FakeTensor) for a in args):
            # A host constant (a filter bank, say), not a device tensor: its
            # values are read on the host without a sync.
            with unset_fake_temporarily():
                return func(*args, **(kwargs or {}))
        self.reads.append((what, _site(traceback.extract_stack()[:-1])))
        if what in _FATAL_UNDER_FAKE:
            raise HostRead(what)
        return func(*args, **(kwargs or {}))


@dataclasses.dataclass
class RunArtifacts:
    entry: EntrySpec
    inputs: Any = None                   # the materialized arguments
    input_specs: list | None = None      # (shape, dtype, device) of the carried leaves, before
    output: Any = None
    reads: list = dataclasses.field(default_factory=list)
    stopped: str | None = None           # the host read that stopped the run, and where


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _materialize(tree):
    """The argument tree with each spec made: a tensor (a fake one, under
    ``FakeTensorMode``) or a seeded generator."""
    if isinstance(tree, TensorSpec):
        return torch.zeros(tree.shape, dtype=tree.dtype)
    if isinstance(tree, GeneratorSpec):
        return torch.Generator().manual_seed(tree.seed)
    if isinstance(tree, dict):
        return {k: _materialize(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_materialize(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_materialize(v) for v in tree)
    return tree


def _spec_of(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


def _carried(entry: EntrySpec, args, output):
    """(input leaves, output leaves) of the entry's carried state."""
    argnum, out_index = entry.carry
    ins = _leaves(args[argnum])
    if output is None:  # updated in place
        outs = ins
    else:
        outs = _leaves(output if out_index is None else output[out_index])
    return ins, outs


def collect(entry: EntrySpec) -> RunArtifacts:
    """Run the entry once at its pinned shapes under fake tensors,
    recording its host reads."""
    art = RunArtifacts(entry=entry)
    recorder = _HostReadRecorder()
    try:
        # Non-fake inputs are the entries' host constants (filter taps).
        with FakeTensorMode(allow_non_fake_inputs=True):
            art.inputs = _materialize(entry.args)
            if entry.carry is not None:
                art.input_specs = [_spec_of(t) for t in _leaves(art.inputs[entry.carry[0]])]
            with recorder:
                art.output = entry.fn(*art.inputs, **entry.static_kwargs)
    except (HostRead, DataDependentOutputException, DynamicOutputShapeException) as exc:
        what = str(exc) if isinstance(exc, HostRead) else type(exc).__name__
        art.stopped = f"{what} at {_site(traceback.extract_tb(exc.__traceback__))}"
    except Exception as exc:
        raise RuntimeError(f"contract run failed for {entry.name}") from exc
    art.reads = recorder.reads
    return art


# ---------------------------------------------------------------------------
# Rules. Each maps RunArtifacts -> list[Violation].
# ---------------------------------------------------------------------------

def rule_host_sync(art: RunArtifacts) -> list[Violation]:
    out = []
    for what, site in art.reads:
        out.append(Violation(
            rule="host-sync", subject=art.entry.name,
            message=f"{what} at {site}: a device-to-host sync on every call on the card",
        ))
    if art.stopped is not None and not art.reads:
        out.append(Violation(
            rule="host-sync", subject=art.entry.name,
            message=f"a data-dependent read ({art.stopped}) stopped the fake-tensor run: "
                    "a device-to-host sync on every call on the card",
        ))
    return out


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage()._cdata == b.untyped_storage()._cdata


def rule_state_in_place(art: RunArtifacts) -> list[Violation]:
    entry = art.entry
    if not entry.must_alias or art.stopped is not None or entry.carry is None:
        return []
    if entry.carry[0] not in entry.must_alias:
        return []
    ins, outs = _carried(entry, art.inputs, art.output)
    if len(ins) != len(outs):
        return [Violation(
            rule="state-in-place", subject=entry.name,
            message=f"carried state has {len(ins)} input leaves but {len(outs)} output leaves",
        )]
    fresh = [i for i, (a, b) in enumerate(zip(ins, outs)) if not _same_storage(a, b)]
    if not fresh:
        return []
    return [Violation(
        rule="state-in-place", subject=entry.name,
        message=f"carried leaves {fresh} come back in fresh storage: the step allocates "
                "its state anew on every call instead of updating it in place",
    )]


def rule_float64_leak(art: RunArtifacts) -> list[Violation]:
    return [
        Violation(
            rule="float64-leak", subject=art.entry.name,
            message=f"output leaf {i} is float64 {tuple(t.shape)}: a silent 2x memory "
                    "and bandwidth promotion on the hot path",
        )
        for i, t in enumerate(_leaves(art.output)) if t.dtype == torch.float64
    ]


def rule_carry_stable(art: RunArtifacts) -> list[Violation]:
    entry = art.entry
    if entry.carry is None or art.stopped is not None:
        return []
    _, outs = _carried(entry, art.inputs, art.output)
    if len(outs) != len(art.input_specs):
        return [Violation(
            rule="carry-stable", subject=entry.name,
            message=f"carried state has {len(art.input_specs)} input leaves but "
                    f"{len(outs)} output leaves",
        )]
    out = []
    for i, (want, t) in enumerate(zip(art.input_specs, outs)):
        if _spec_of(t) != want:
            out.append(Violation(
                rule="carry-stable", subject=entry.name,
                message=f"carried leaf {i} changes across the call: {want} -> {_spec_of(t)}",
            ))
    return out


RULES = {
    "host-sync": rule_host_sync,
    "state-in-place": rule_state_in_place,
    "float64-leak": rule_float64_leak,
    "carry-stable": rule_carry_stable,
}


def check_entry(entry: EntrySpec) -> list[Violation]:
    """Run one entry and every contract rule over it."""
    art = collect(entry)
    violations: list[Violation] = []
    for rule in RULES.values():
        violations.extend(rule(art))
    return violations


def check_registry(entries) -> tuple[list[Violation], list[dict]]:
    """Check every entry; returns (violations, per-entry report rows)."""
    violations: list[Violation] = []
    rows: list[dict] = []
    for entry in entries:
        found = check_entry(entry)
        violations.extend(found)
        rows.append({
            "entry": entry.name,
            "description": entry.description,
            "rules": sorted(RULES),
            "violations": len(found),
        })
    return violations, rows
