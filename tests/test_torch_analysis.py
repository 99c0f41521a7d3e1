"""The port's static checks (``repro_torch.analysis``), on the CPU.

The twin of ``tests/test_analysis.py``:

  * planted violations: a tiny broken entry or source file for every
    contract and lint rule of the port, each asserting that its rule
    FIRES (and a clean twin that it does not);
  * the suppressions file: every entry has a reason, an empty reason is
    refused, subjects match by prefix;
  * the real tree: the registry covers every entry name of the JAX
    package's registry, the full analysis is clean, the CLI's exit codes
    are right;
  * the sanitizer: ``guard_methods`` counts syncs by call site, here on a
    stubbed ``torch.cuda.set_sync_debug_mode`` (there is no card).
"""

from __future__ import annotations

import json
import warnings

import pytest
import torch

from repro.analysis import registry as jax_registry
from repro_torch.analysis import (
    Suppression,
    Violation,
    load_suppressions,
    run_analysis,
    split_suppressed,
)
from repro_torch.analysis import contracts, lint, registry, sanitizers
from repro_torch.analysis.registry import EntrySpec, TensorSpec

torch.set_num_threads(1)


def _rules_fired(entry) -> set[str]:
    return {v.rule for v in contracts.check_entry(entry)}


def _f32(*shape):
    return TensorSpec(tuple(shape))


# ---------------------------------------------------------------------------
# Contract rules on planted entries.
# ---------------------------------------------------------------------------

class TestPlantedContracts:
    def test_item_fires_host_sync(self):
        def bad(x):
            return x * x.sum().item()

        found = contracts.check_entry(EntrySpec(name="bad.item", fn=bad, args=(_f32(4),)))
        assert [v.rule for v in found] == ["host-sync"]
        assert ".item()" in found[0].message and "test_torch_analysis.py" in found[0].message

    def test_boolean_mask_fires_host_sync(self):
        def bad(x):
            return x[x > 0]

        assert "host-sync" in _rules_fired(EntrySpec(name="bad.mask", fn=bad, args=(_f32(4),)))

    def test_cpu_read_fires_and_the_run_goes_on(self):
        def bad(x):
            return (x + 1).cpu().sum().item()

        found = contracts.check_entry(EntrySpec(name="bad.cpu", fn=bad, args=(_f32(4),)))
        assert [v.message.split(" at ")[0] for v in found] == [".cpu()", ".item()"]

    def test_host_constants_are_not_syncs(self):
        taps = torch.tensor([0.5, 0.25])

        def good(x):
            return sum(x * t for t in taps.tolist())

        assert not _rules_fired(EntrySpec(name="good.taps", fn=good, args=(_f32(4),)))

    def test_fresh_state_fires_state_in_place(self):
        def bad(state, x):
            return state + 1, x * 2

        entry = EntrySpec(name="bad.fresh", fn=bad, args=(_f32(3), _f32(4)),
                          must_alias=(0,), carry=(0, 0))
        assert _rules_fired(entry) == {"state-in-place"}

    def test_in_place_state_is_clean(self):
        def step(state, x):
            state.add_(1)
            return state, x * 2

        def splice(state, x):
            state[0] = x.sum()

        for fn, carry in ((step, (0, 0)), (splice, (0, None))):
            entry = EntrySpec(name="good.in_place", fn=fn, args=(_f32(3), _f32(4)),
                              must_alias=(0,), carry=carry)
            assert not _rules_fired(entry)

    def test_float64_output_fires(self):
        def bad(x):
            return x.to(torch.float64)

        assert _rules_fired(EntrySpec(name="bad.f64", fn=bad, args=(_f32(4),))) == {"float64-leak"}

    @pytest.mark.parametrize("drift", ["dtype", "shape", "device"])
    def test_carry_drift_fires(self, drift):
        def bad(state, x):
            if drift == "dtype":
                return state.to(torch.int32), x
            if drift == "shape":
                return state[:2], x
            return torch.zeros(state.shape, device="cuda"), x  # fake: no card needed

        entry = EntrySpec(name=f"bad.carry_{drift}", fn=bad, args=(_f32(3), _f32(4)),
                          carry=(0, 0))
        assert "carry-stable" in _rules_fired(entry)


# ---------------------------------------------------------------------------
# Lint rules on planted sources.
# ---------------------------------------------------------------------------

def _lint(tmp_path, rel, source, rule, roots=(("repro_torch.serving.bad", "step"),)):
    """Write ``source`` at ``rel`` under a fake repo root and run one rule."""
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    modules = [lint._Module(str(tmp_path), str(path))]
    return lint.RULES[rule](modules, lint.entry_reachable(modules, set(roots)))


class TestPlantedLint:
    def test_numpy_in_entry_fires(self, tmp_path):
        src = ("import numpy as np\n"
               "def step(x):\n    return helper(x)\n"
               "def helper(x):\n    return np.asarray(x) + 1\n"
               "def host_only(x):\n    return np.asarray(x)\n")
        found = _lint(tmp_path, "src/repro_torch/serving/bad.py", src, "numpy-in-entry")
        assert [v.subject for v in found] == ["src/repro_torch/serving/bad.py:5"]
        assert "np.asarray" in found[0].message

    def test_numpy_dtype_attrs_are_benign(self, tmp_path):
        src = "import numpy as np\ndef step(x):\n    return x.view(np.float32)\n"
        assert not _lint(tmp_path, "src/repro_torch/serving/bad.py", src, "numpy-in-entry")

    def test_host_sync_in_entry_fires(self, tmp_path):
        src = ("import torch\n"
               "def step(x):\n"
               "    torch.cuda.synchronize()\n"
               "    return x.sum().item()\n")
        found = _lint(tmp_path, "src/repro_torch/serving/bad.py", src, "host-sync-in-entry")
        assert sorted(v.message.split(" in ")[0] for v in found) == [
            ".item()", "torch.cuda.synchronize()"]

    def test_card_only_linalg_sync_fires_host_sync_in_entry(self, tmp_path):
        """An eigh reached from an entry is a sync on the card only (its info
        check), which the fake-tensor contracts cannot see: the lint names it."""
        src = ("import torch\n"
               "def step(x):\n    return helper(x)\n"
               "def helper(x):\n    return torch.linalg.eigh(x)\n"
               "def host_only(x):\n    return torch.linalg.eigh(x)\n")
        found = _lint(tmp_path, "src/repro_torch/serving/bad.py", src, "host-sync-in-entry")
        assert [v.subject for v in found] == ["src/repro_torch/serving/bad.py:5"]
        assert "torch.linalg.eigh() (a sync only on the card)" in found[0].message

    def test_tensor_construction_in_loop_fires_only_in_hot_modules(self, tmp_path):
        src = ("import torch\n"
               "def f(items):\n"
               "    return [torch.zeros(3) + i for i in items] + [t for t in items\n"
               "        if t]\n"
               "def g(items):\n"
               "    out = []\n"
               "    for it in items:\n"
               "        out.append(torch.as_tensor(it))\n"
               "    return out\n")
        rule = "tensor-construction-in-host-loop"
        found = _lint(tmp_path, "src/repro_torch/core/bad.py", src, rule)
        assert [v.subject for v in found] == ["src/repro_torch/core/bad.py:8"]
        assert not _lint(tmp_path, "src/repro_torch/models/cool.py", src, rule)

    _OPS_HEAD = ("from repro_torch.kernels._route import on_cuda\n"
                 "from repro_torch.kernels.foo import kernel as _kernel\n"
                 "from repro_torch.kernels.foo import ref as _ref\n")

    def test_swallowed_launch_fires_kernel_fallback(self, tmp_path):
        src = self._OPS_HEAD + (
            "def foo(x):\n"
            "    if on_cuda(x, 'foo'):\n"
            "        try:\n"
            "            return _kernel.foo(x)\n"
            "        except RuntimeError:\n"
            "            pass\n"
            "    return _ref.foo(x)\n")
        found = _lint(tmp_path, "src/repro_torch/kernels/foo/ops.py", src, "kernel-fallback")
        assert len(found) == 2  # the swallowed launch, and the plain call it falls to
        assert any("not re-raised" in v.message for v in found)

    def test_unrouted_plain_call_fires_kernel_fallback(self, tmp_path):
        src = self._OPS_HEAD + (
            "def plain(x):\n    return _ref.foo(x).sum()\n"
            "def foo(x, big):\n"
            "    if big:\n"
            "        return plain(x)\n"
            "    if on_cuda(x, 'foo'):\n"
            "        return _kernel.foo(x)\n"
            "    return _ref.foo(x)\n")
        found = _lint(tmp_path, "src/repro_torch/kernels/foo/ops.py", src, "kernel-fallback")
        assert [v.subject for v in found] == ["src/repro_torch/kernels/foo/ops.py:8"]
        assert "plain" in found[0].message

    def test_routed_ops_are_clean(self, tmp_path):
        src = self._OPS_HEAD + (
            "def foo(x):\n"
            "    if not on_cuda(x, 'foo'):\n"
            "        return _ref.foo(x)\n"
            "    try:\n"
            "        return _kernel.foo(x)\n"
            "    except RuntimeError as exc:\n"
            "        raise ValueError('foo') from exc\n"
            "def bar(x):\n"
            "    run = _kernel if on_cuda(x, 'bar') else _ref\n"
            "    return run.bar(x)\n"
            "def baz(x):\n"
            "    if on_cuda(x, 'baz'):\n"
            "        y = _kernel.baz(x)\n"
            "    else:\n"
            "        y = _ref.baz(x)\n"
            "    return y\n")
        assert not _lint(tmp_path, "src/repro_torch/kernels/foo/ops.py", src, "kernel-fallback")

    def test_unreferenced_export_fires(self, tmp_path):
        other = tmp_path / "tests" / "test_x.py"
        other.parent.mkdir(parents=True)
        other.write_text("from repro_torch.mod import used\n")
        path = tmp_path / "src/repro_torch/mod.py"
        path.parent.mkdir(parents=True)
        path.write_text("def used(): pass\ndef never_called_anywhere_xyz(): pass\n"
                        "__all__ = ['used', 'never_called_anywhere_xyz']\n")
        found = lint.rule_unreferenced_export(
            [lint._Module(str(tmp_path), str(path))], set(), root=str(tmp_path))
        assert [v.subject for v in found] == ["src/repro_torch/mod.py:3"]
        assert "never_called_anywhere_xyz" in found[0].message


# ---------------------------------------------------------------------------
# Suppressions.
# ---------------------------------------------------------------------------

class TestSuppressions:
    def test_committed_file_loads_and_every_entry_has_a_reason(self):
        sups = load_suppressions()
        assert sups
        assert all(len(s.reason.split()) >= 10 for s in sups)

    def test_empty_reason_refused(self, tmp_path):
        p = tmp_path / "sup.json"
        p.write_text(json.dumps([{"rule": "r", "subject": "s", "reason": "  "}]))
        with pytest.raises(ValueError, match="reason"):
            load_suppressions(str(p))

    def test_prefix_matching(self):
        s = Suppression(rule="r", subject="src/repro_torch/x.py", reason="why")
        assert s.matches(Violation("r", "src/repro_torch/x.py:12", "m"))
        assert not s.matches(Violation("r", "src/repro_torch/y.py:12", "m"))
        assert not s.matches(Violation("other", "src/repro_torch/x.py:12", "m"))
        live, quiet = split_suppressed(
            [Violation("r", "src/repro_torch/x.py:1", "m"), Violation("r", "z", "m")], [s])
        assert len(live) == 1 and len(quiet) == 1


# ---------------------------------------------------------------------------
# The real tree.
# ---------------------------------------------------------------------------

class TestRealTree:
    def test_registry_covers_every_jax_entry(self):
        port = registry.build_registry()
        assert {e.name for e in port} == {e.name for e in jax_registry.build_registry()}
        assert (registry.B, registry.D, registry.N_SHARDS) == (
            jax_registry.B, jax_registry.D, jax_registry.N_SHARDS)
        assert registry._pinned_cfg().forest._asdict() == jax_registry._pinned_cfg().forest._asdict()

    def test_full_analysis_is_clean(self):
        report = run_analysis()
        assert report["violations"] == [], report["violations"]
        assert report["summary"]["entries_run"] == len(registry.build_registry())
        assert report["summary"]["rules"] == len(contracts.RULES) + len(lint.RULES)
        for v in report["suppressed"]:
            assert v["reason"].strip()

    def test_cli_exit_codes(self, tmp_path, capsys, monkeypatch):
        from repro_torch.analysis import __main__ as cli

        out = tmp_path / "report.json"
        assert cli.main(["--lint-only", "--json", str(out)]) == 0
        assert json.loads(out.read_text())["summary"]["violations"] == 0
        # Without its suppressions the tree has live violations: exit 1.
        import repro_torch.analysis as pkg

        monkeypatch.setattr(pkg, "load_suppressions", lambda: [])
        assert cli.main(["--lint-only"]) == 1
        assert "VIOLATION" in capsys.readouterr().out
        with pytest.raises(SystemExit):
            cli.main(["--lint-only", "--contracts-only"])

    def test_reachability_follows_the_real_call_graph(self):
        reachable = lint.entry_reachable(lint.load_modules())
        assert ("src/repro_torch/signal/frontend.py", "chunk_features") in reachable
        assert ("src/repro_torch/signal/mspca.py", "denoise_windows") in reachable
        assert ("src/repro_torch/kernels/forest/ref.py", "forest_traverse") in reachable
        assert not any(rel.startswith("src/repro_torch/analysis/") for rel, _ in reachable)


# ---------------------------------------------------------------------------
# The sanitizer.
# ---------------------------------------------------------------------------

def test_guard_methods_counts_syncs_by_site(monkeypatch):
    """A stubbed sync debug mode: the guarded method's syncs are counted by
    call site, the exempt host copy's are not, other warnings pass, and
    every attribute is restored on exit."""
    modes = []
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1] if modes else 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

    def sync():
        if modes[-1] != 0:
            warnings.warn(f"{sanitizers.SYNC_WARNING} cudaStreamSynchronize", UserWarning,
                          stacklevel=2)

    class Host:
        @staticmethod
        def copy():
            sync()

    class Engine:
        def step(self):
            for _ in range(3):
                sync()
            Host.copy()
            warnings.warn("something else", RuntimeWarning)

    engine = Engine()
    with pytest.warns(RuntimeWarning, match="something else"):
        with sanitizers.guard_methods(engine, "step", exempt=((Host, "copy"),)) as count:
            engine.step()
            engine.step()
    assert count.total == 6 and len(count.by_site) == 1
    (site,) = count.by_site
    assert site.startswith("tests/test_torch_analysis.py:")
    assert "step" not in vars(engine) and isinstance(vars(Host)["copy"], staticmethod)
    assert modes[0] == "warn" and modes[-1] == 0
