"""Runtime sanitizer: the dynamic half of the port's static checks.

The contract checker (``contracts``) runs each entry under fake tensors;
``guard_methods`` watches the running program on the card. It wraps
chosen methods (or module functions) in ``torch.cuda.set_sync_debug_mode``
and counts the device-to-host syncs they make, by call site (the twin of
the reference's ``transfer_guard("disallow")`` around the engine's hot
methods). The explicit host copies (``serving.api._host_copy``, through
which the engine reads its events and slots) are exempt.

It runs in ``"warn"`` mode only, counting: ``torch.linalg.eigh`` syncs
on every engine step on the card, so ``"error"`` (raise at the first
sync) would stop the engine today. The recompile budgets of the
reference (``budgets.json``, ``CompileCounter``) need a captured engine
step first and are not ported.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import warnings

import torch

# The text of the warning ``set_sync_debug_mode("warn")`` raises at a sync.
SYNC_WARNING = "called a synchronizing CUDA operation"
_MISSING = object()
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


class SyncCount:
    """Syncs seen inside guarded calls: {``path:line``: count}."""

    def __init__(self):
        self.by_site: collections.Counter = collections.Counter()

    @property
    def total(self) -> int:
        return sum(self.by_site.values())

    def record(self, filename: str, lineno: int) -> None:
        path = os.path.abspath(filename)
        if path.startswith(_ROOT):
            path = os.path.relpath(path, _ROOT)
        self.by_site[f"{path}:{lineno}"] += 1


def _default_exempt():
    from repro_torch.serving import api

    return ((api, "_host_copy"),)


@contextlib.contextmanager
def _sync_debug_mode(mode):
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _guarded(fn, count: SyncCount):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        caught: list = []
        try:
            with warnings.catch_warnings(record=True) as caught, _sync_debug_mode("warn"):
                warnings.simplefilter("always")
                return fn(*args, **kwargs)
        finally:
            # Out of the recording block: other warnings go on to the caller.
            for w in caught:
                if SYNC_WARNING in str(w.message):
                    count.record(w.filename, w.lineno)
                else:
                    warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)

    wrapper.__guarded_by_sync_debug__ = True
    return wrapper


def _exempted(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _sync_debug_mode(0):
            return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def guard_methods(obj, *method_names: str, exempt=None):
    """Within the block, ``obj``'s named methods run under
    ``torch.cuda.set_sync_debug_mode("warn")``; yields the ``SyncCount`` of
    the syncs they make. ``exempt``: (owner, name) functions that run with the
    debug mode off (default: ``serving.api._host_copy``). Attributes are
    restored on exit; an already guarded method is left as it is, so
    guards nest."""
    count = SyncCount()
    patched = []  # (owner, name, what its own __dict__ held, or _MISSING)

    def patch(owner, name, wrapper):
        patched.append((owner, name, vars(owner).get(name, _MISSING)))
        setattr(owner, name, wrapper)

    for owner, name in (_default_exempt() if exempt is None else exempt):
        patch(owner, name, _exempted(getattr(owner, name)))
    for name in method_names:
        fn = getattr(obj, name)
        if not getattr(fn, "__guarded_by_sync_debug__", False):
            patch(obj, name, _guarded(fn, count))
    try:
        yield count
    finally:
        for owner, name, held in reversed(patched):
            if held is _MISSING:
                delattr(owner, name)
            else:
                setattr(owner, name, held)
