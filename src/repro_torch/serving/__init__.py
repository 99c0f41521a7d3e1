from repro_torch.serving.api import (
    AlarmCleared,
    AlarmRaised,
    ChunkScored,
    EngineState,
    ScoringProgram,
    SeizureEngine,
    StreamSession,
)

__all__ = [
    "AlarmCleared",
    "AlarmRaised",
    "ChunkScored",
    "EngineState",
    "ScoringProgram",
    "SeizureEngine",
    "StreamSession",
]
