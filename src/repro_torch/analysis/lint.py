"""AST lint over ``src/repro_torch`` for hazards of the port that a generic
linter cannot see: which functions a registered device entry reaches,
which modules are on the hot path, how a kernel op routes, which names
form the public surface. Subjects are repo-relative ``path:line``, so a
suppression can pin a site or a path prefix. The twin of
``repro.analysis.lint``, each rule given its torch meaning:

  numpy-in-entry                 (``numpy-in-jit``) ``np.*`` CALLS in
                                 functions reachable from a registered
                                 entry (``registry.entry_roots``): a
                                 numpy call there runs on the host, on a
                                 host copy of device data. dtype and
                                 constant attributes (``np.float32``,
                                 ``np.pi``) are exempt.
  host-sync-in-entry             (``host-coercion-in-jit``) ``.item()``,
                                 ``.cpu()``, ``.numpy()``, ``.tolist()``
                                 or ``torch.cuda.synchronize`` in
                                 entry-reachable code: a device-to-host
                                 sync on the hot path. Also the
                                 ``torch.linalg`` calls whose CUDA
                                 versions read their solver's ``info`` on
                                 the host (``eigh``, ``cholesky``, ...):
                                 a sync only on the card, which the
                                 fake-tensor run of ``contracts`` cannot
                                 see.
  tensor-construction-in-host-loop (``jnp-construction-in-host-loop``)
                                 ``torch.tensor``/``zeros``/``arange``/...
                                 inside a Python loop in a hot module: an
                                 allocation and, on the card, a launch
                                 (or a host-to-device copy) per
                                 iteration.
  kernel-fallback                (``kernel-interpret-fallback``) a
                                 ``kernels/*/ops.py`` that catches a
                                 failed kernel build or launch without
                                 re-raising, or that can hand a CUDA
                                 tensor to anything but its kernel: a
                                 plain-version call not confined to the
                                 CPU branch of ``_route.on_cuda``. This
                                 is the port's no-fallback rule, as a
                                 check.
  unreferenced-export            a name in a module's ``__all__`` that no
                                 other file (the port, the tests, the
                                 tools, ``chip_smoke.py``) references.
"""

from __future__ import annotations

import ast
import os
import re

from repro_torch.analysis.base import Violation

PACKAGE = "src/repro_torch"
# Modules whose host-side loops are on the serving or training hot path.
HOT_MODULE_PREFIXES = (
    "src/repro_torch/serving/",
    "src/repro_torch/signal/",
    "src/repro_torch/core/",
    "src/repro_torch/kernels/",
)
# Where an export may be referenced from.
CORPUS = ("src/repro_torch", "tests", "tools", "chip_smoke.py")

# np.<attr> uses that are dtypes or constants, not host array operations.
_NP_BENIGN = {
    "float32", "float64", "int8", "int16", "int32", "int64", "uint8", "uint16",
    "uint32", "uint64", "bool_", "ndarray", "dtype", "generic", "number",
    "pi", "e", "inf", "nan", "newaxis", "integer", "floating",
}
_TORCH_CONSTRUCTORS = {
    "tensor", "as_tensor", "from_numpy", "zeros", "ones", "full", "empty", "arange",
    "linspace", "eye", "zeros_like", "ones_like", "full_like", "empty_like",
}
_SYNC_METHODS = {"item", "cpu", "numpy", "tolist"}
# torch.linalg calls whose CUDA versions check the solver's info on the host.
_CARD_SYNC_LINALG = {"eigh", "eigvalsh", "cholesky", "inv", "solve"}


def _repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))  # src/repro_torch/analysis
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def iter_py_files(root: str, subdirs=(PACKAGE,)):
    for sub in subdirs:
        base = os.path.join(root, sub)
        if os.path.isfile(base):
            yield base
            continue
        for dirpath, _, files in os.walk(base):
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)


def _rel(root: str, path: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


class _Module:
    """A parsed module and the semantic context the rules need."""

    def __init__(self, root: str, path: str):
        self.path = path
        self.rel = _rel(root, path)
        with open(path) as f:
            self.src = f.read()
        self.tree = ast.parse(self.src, filename=self.rel)
        self.functions: dict[str, ast.AST] = {
            n.name: n for n in self.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        # local name -> dotted port module (``from repro_torch.x import mod``,
        # ``import repro_torch.x as z``), and local name -> (module, name)
        # for ``from repro_torch.x import fn``.
        self.module_aliases: dict[str, str] = {}
        self.imported_names: dict[str, tuple[str, str]] = {}
        self.import_aliases: dict[str, set[str]] = {}  # ``_aliases``' answers
        for n in ast.walk(self.tree):
            if isinstance(n, ast.ImportFrom) and n.module and (
                n.module == "repro_torch" or n.module.startswith("repro_torch.")
            ):
                for a in n.names:
                    local = a.asname or a.name
                    self.module_aliases[local] = f"{n.module}.{a.name}"
                    self.imported_names[local] = (n.module, a.name)
            elif isinstance(n, ast.Import):
                for a in n.names:
                    if a.name.startswith("repro_torch"):
                        self.module_aliases[a.asname or a.name] = a.name

    @property
    def dotted(self) -> str:
        rel = self.rel[len("src/"):] if self.rel.startswith("src/") else self.rel
        rel = rel[:-3] if rel.endswith(".py") else rel
        if rel.endswith("/__init__"):
            rel = rel[: -len("/__init__")]
        return rel.replace("/", ".")

    def dunder_all(self) -> list[tuple[str, int]]:
        for n in self.tree.body:
            if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in n.targets
            ) and isinstance(n.value, (ast.List, ast.Tuple)):
                return [(e.value, e.lineno) for e in n.value.elts
                        if isinstance(e, ast.Constant) and isinstance(e.value, str)]
        return []


def load_modules(root: str | None = None) -> list[_Module]:
    root = root or _repo_root()
    return [_Module(root, p) for p in iter_py_files(root)]


# ---------------------------------------------------------------------------
# Reachability from the registered entries.
# ---------------------------------------------------------------------------

def _called_functions(fn_node, mod: _Module, by_dotted: dict):
    """(module, function name) pairs this body calls, resolved locally or
    through a port import."""
    out = []
    for n in ast.walk(fn_node):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        if isinstance(f, ast.Name):
            if f.id in mod.functions:
                out.append((mod, f.id))
            elif f.id in mod.imported_names:
                owner, name = mod.imported_names[f.id]
                target = by_dotted.get(owner)
                if target is not None and name in target.functions:
                    out.append((target, name))
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            target = by_dotted.get(mod.module_aliases.get(f.value.id, ""))
            if target is not None and f.attr in target.functions:
                out.append((target, f.attr))
    return out


def entry_reachable(modules: list[_Module], roots=None) -> set[tuple[str, str]]:
    """(module.rel, function name) closure reachable from ``roots``
    ((dotted module, function name) pairs; the registry's entries by
    default), following same-module calls and port imports."""
    if roots is None:
        from repro_torch.analysis import registry

        roots = registry.entry_roots()
    by_dotted = {m.dotted: m for m in modules}
    frontier = [(by_dotted[mod], name) for mod, name in roots if mod in by_dotted]
    seen: set[tuple[str, str]] = set()
    while frontier:
        mod, name = frontier.pop()
        if (mod.rel, name) in seen or name not in mod.functions:
            continue
        seen.add((mod.rel, name))
        frontier.extend(_called_functions(mod.functions[name], mod, by_dotted))
    return seen


def _reachable_calls(modules, reachable):
    """(module, function name, Call node) of every call in reachable code."""
    for mod in modules:
        for fname, fn in mod.functions.items():
            if (mod.rel, fname) in reachable:
                for n in ast.walk(fn):
                    if isinstance(n, ast.Call):
                        yield mod, fname, n


# ---------------------------------------------------------------------------
# Rules.
# ---------------------------------------------------------------------------

def _aliases(mod: _Module, module: str) -> set[str]:
    """The local names under which ``mod`` imports ``module``, found once a
    module (the rules ask at every call they look at)."""
    if module not in mod.import_aliases:
        mod.import_aliases[module] = {
            a.asname or module for n in ast.walk(mod.tree) if isinstance(n, ast.Import)
            for a in n.names if a.name == module}
    return mod.import_aliases[module]


def rule_numpy_in_entry(modules, reachable):
    out = []
    for mod, fname, n in _reachable_calls(modules, reachable):
        f = n.func
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id in _aliases(mod, "numpy") and f.attr not in _NP_BENIGN):
            out.append(Violation(
                rule="numpy-in-entry", subject=f"{mod.rel}:{n.lineno}",
                message=f"np.{f.attr}(...) in {fname}(), which a registered device entry "
                        "reaches: a host-side numpy call on the hot path",
            ))
    return out


def rule_host_sync_in_entry(modules, reachable):
    out = []
    for mod, fname, n in _reachable_calls(modules, reachable):
        f = n.func
        if not isinstance(f, ast.Attribute):
            continue
        if f.attr in _SYNC_METHODS:
            what = f".{f.attr}()"
        elif f.attr == "synchronize" and ast.unparse(f.value) == "torch.cuda":
            what = "torch.cuda.synchronize()"
        elif f.attr in _CARD_SYNC_LINALG and ast.unparse(f.value) == "torch.linalg":
            what = f"torch.linalg.{f.attr}() (a sync only on the card)"
        else:
            continue
        out.append(Violation(
            rule="host-sync-in-entry", subject=f"{mod.rel}:{n.lineno}",
            message=f"{what} in {fname}(), which a registered device entry reaches: a "
                    "device-to-host sync on the hot path",
        ))
    return out


def rule_tensor_construction_in_host_loop(modules, reachable):
    del reachable
    out = []
    for mod in modules:
        if not mod.rel.startswith(HOT_MODULE_PREFIXES):
            continue
        torch_names = _aliases(mod, "torch")
        for loop in ast.walk(mod.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for n in ast.walk(loop):
                f = n.func if isinstance(n, ast.Call) else None
                if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                        and f.value.id in torch_names and f.attr in _TORCH_CONSTRUCTORS):
                    out.append(Violation(
                        rule="tensor-construction-in-host-loop",
                        subject=f"{mod.rel}:{n.lineno}",
                        message=f"torch.{f.attr}(...) inside a Python "
                                f"{'for' if isinstance(loop, ast.For) else 'while'} loop in a "
                                "hot module: an allocation (a launch or a host-to-device "
                                "copy on the card) per iteration -- hoist it or vectorize",
                    ))
    return sorted(set(out), key=lambda v: v.subject)


def _route_test(test) -> str | None:
    """'cuda' for ``on_cuda(...)``, 'cpu' for ``not on_cuda(...)``, else None."""
    negated = isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
    call = test.operand if negated else test
    if isinstance(call, ast.Call) and ast.unparse(call.func).split(".")[-1] == "on_cuda":
        return "cpu" if negated else "cuda"
    return None


def _terminates(body) -> bool:
    return bool(body) and isinstance(body[-1], (ast.Return, ast.Raise))


def _plain_calls(node, plain: set[str], local_plain: set[str]):
    """Calls into the plain version: ``<ref alias>.f(...)`` or a local
    function that calls it unrouted."""
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) and f.value.id in plain
                or isinstance(f, ast.Name) and f.id in local_plain):
            yield n


def _unrouted_plain_calls(stmts, branch: str, plain, local_plain):
    """Plain-version calls in ``stmts`` that are not confined to the CPU
    branch of an ``on_cuda`` test (``branch``: what is known on entry)."""
    out = []
    for i, st in enumerate(stmts):
        if isinstance(st, ast.If) and _route_test(st.test) is not None:
            taken = _route_test(st.test)
            other = "cpu" if taken == "cuda" else "cuda"
            out += _unrouted_plain_calls(st.body, taken, plain, local_plain)
            out += _unrouted_plain_calls(st.orelse, other, plain, local_plain)
            if _terminates(st.body) and not st.orelse:
                out += _unrouted_plain_calls(stmts[i + 1:], other, plain, local_plain)
                return out
            continue
        if branch == "cpu":
            continue
        routed = set()
        for n in ast.walk(st):  # ``_kernel if on_cuda(x) else _ref``
            if isinstance(n, ast.IfExp) and _route_test(n.test) is not None:
                cpu_side = n.orelse if _route_test(n.test) == "cuda" else n.body
                routed |= {id(c) for c in _plain_calls(cpu_side, plain, local_plain)}
        for c in _plain_calls(st, plain, local_plain):
            if id(c) not in routed:
                out.append(c)
    return out


def rule_kernel_fallback(modules, reachable):
    del reachable
    out = []
    for mod in modules:
        parts = mod.rel.split("/")
        if parts[:3] != ["src", "repro_torch", "kernels"] or parts[-1] != "ops.py":
            continue
        aliases = mod.module_aliases
        kernel = {k for k, v in aliases.items() if v.endswith((".kernel", ".build"))}
        plain = {k for k, v in aliases.items() if v.endswith(".ref")}
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.Try):
                continue
            calls_kernel = any(
                isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
                and isinstance(c.func.value, ast.Name) and c.func.value.id in kernel
                for st in n.body for c in ast.walk(st)
            )
            swallowed = [h for h in n.handlers if not any(isinstance(x, ast.Raise) for x in ast.walk(h))]
            if calls_kernel and swallowed:
                out.append(Violation(
                    rule="kernel-fallback", subject=f"{mod.rel}:{swallowed[0].lineno}",
                    message="a failed kernel build or launch is caught and not re-raised: "
                            "the op falls back instead of failing",
                ))
        routers = {name for name, fn in mod.functions.items()
                   if any(_route_test(x) for x in ast.walk(fn) if isinstance(x, ast.expr))}
        # Plain-version helpers: module functions that call ref unrouted.
        local_plain = {name for name, fn in mod.functions.items()
                       if name not in routers and any(True for _ in _plain_calls(fn, plain, set()))}
        for name in sorted(routers):
            for c in _unrouted_plain_calls(mod.functions[name].body, "any", plain, local_plain):
                out.append(Violation(
                    rule="kernel-fallback", subject=f"{mod.rel}:{c.lineno}",
                    message=f"{name}() can hand a CUDA tensor to the plain version "
                            f"({ast.unparse(c.func)}): only the CPU branch of on_cuda may "
                            "reach it",
                ))
    return out


def rule_unreferenced_export(modules, reachable, root=None):
    del reachable
    root = root or _repo_root()
    corpus = {}
    for p in iter_py_files(root, tuple(s for s in CORPUS if os.path.exists(os.path.join(root, s)))):
        with open(p) as fh:
            corpus[_rel(root, p)] = fh.read()
    out = []
    for mod in modules:
        for name, lineno in mod.dunder_all():
            pattern = re.compile(rf"\b{re.escape(name)}\b")
            if not any(rel != mod.rel and name in src and pattern.search(src)
                       for rel, src in corpus.items()):
                out.append(Violation(
                    rule="unreferenced-export", subject=f"{mod.rel}:{lineno}",
                    message=f"__all__ export {name!r} is referenced nowhere else in "
                            f"{', '.join(CORPUS)}: dead public surface -- remove it or "
                            "suppress it with the reason it stays",
                ))
    return out


RULES = {
    "numpy-in-entry": rule_numpy_in_entry,
    "host-sync-in-entry": rule_host_sync_in_entry,
    "tensor-construction-in-host-loop": rule_tensor_construction_in_host_loop,
    "kernel-fallback": rule_kernel_fallback,
    "unreferenced-export": rule_unreferenced_export,
}


def check_tree(root: str | None = None) -> list[Violation]:
    """Every lint rule over src/repro_torch."""
    root = root or _repo_root()
    modules = load_modules(root)
    reachable = entry_reachable(modules)
    violations: list[Violation] = []
    for rule in RULES.values():
        violations.extend(rule(modules, reachable))
    violations.sort(key=lambda v: (v.rule, v.subject))
    return violations
