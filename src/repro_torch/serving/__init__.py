"""Serving surface.

The seizure engine (``repro_torch.serving.api``: ``SeizureEngine`` and
its event types) is imported eagerly. The LM engines
(``engine.ServeEngine`` / ``make_serve_step`` and
``continuous.ContinuousEngine`` / ``Request``) load on first access, as
the reference's quarantined LM stack does, so importing the package pulls
in only the seizure path.
"""

from repro_torch.serving.api import (
    AlarmCleared,
    AlarmRaised,
    ChunkScored,
    EngineState,
    ScoringProgram,
    SeizureEngine,
    StreamSession,
)

_LM = {
    "ServeEngine": ("repro_torch.serving.engine", "ServeEngine"),
    "make_serve_step": ("repro_torch.serving.engine", "make_serve_step"),
    "ContinuousEngine": ("repro_torch.serving.continuous", "ContinuousEngine"),
    "Request": ("repro_torch.serving.continuous", "Request"),
}


def __getattr__(name: str):
    target = _LM.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target[0]), target[1])


__all__ = [
    "AlarmCleared",
    "AlarmRaised",
    "ChunkScored",
    "EngineState",
    "ScoringProgram",
    "SeizureEngine",
    "StreamSession",
    # LM engines (lazy)
    "ServeEngine",
    "make_serve_step",
    "ContinuousEngine",
    "Request",
]
