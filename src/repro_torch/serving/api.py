"""Streaming-session seizure scoring in PyTorch (the twin of
``repro.serving.api``; paper Sec. 2.6 deployed).

* ``ScoringProgram`` -- the frozen inference artifact: packed forest,
  training feature statistics and ``PipelineConfig``, saved and loaded
  in exactly the reference's checkpoint layout (a JAX-saved program
  loads here and the other way round).
* ``SeizureEngine`` -- a continuous-batching slot scheduler: ``max_batch``
  slots, each bound to one patient session, whose device state carries
  the slot's k-of-m alarm ring and frontend context. A step scores up to
  ``replay_depth`` backlogged chunks per slot: the heavy stage (MSPCA
  denoise, WPD features, forest vote) runs once over the flattened
  (B*D) chunks (``megabatch=True``, the default), and only the alarm
  ring advances sequentially over the (B, D) votes. ``megabatch=False``
  runs the serial per-chunk oracle.
* ``StreamSession`` -- one patient's handle: ``push`` windows of any
  length, read ``ChunkScored`` / ``AlarmRaised`` / ``AlarmCleared``
  events from ``engine.poll()``.

The engine's state lives on its device (CUDA unless ``device="cpu"`` is
asked for). ``swap_program`` installs a retrained program into the
running engine and bumps the ``program_version`` every ``ChunkScored``
carries. Snapshot/restore and mesh sharding of the reference engine are
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint import store as ckpt_store
from repro_torch.core import rotation_forest as rf
from repro_torch.core.rotation_forest import RotationForestConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.forest import ops as forest_ops
from repro_torch.signal import eeg_data, features, frontend
from repro_torch.signal.pipeline import FittedPipeline, PipelineConfig, check_supported


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------

class ChunkScored(NamedTuple):
    """One 8-minute chunk of one patient was scored."""

    patient_id: int
    chunk_index: int       # per-session sequence number (0-based)
    chunk_pred: int        # 1 = chunk voted preictal
    preictal_frac: float   # fraction of the chunk's windows voted preictal
    alarm: int             # k-of-m alarm state AFTER this chunk
    window_preds: np.ndarray  # (chunk_windows,) int32 per-window labels
    program_version: int = 0


class AlarmRaised(NamedTuple):
    """The k-of-m rule transitioned 0 -> 1 at this chunk."""

    patient_id: int
    chunk_index: int


class AlarmCleared(NamedTuple):
    """The k-of-m rule transitioned 1 -> 0 (hits aged out of the ring)."""

    patient_id: int
    chunk_index: int


# ---------------------------------------------------------------------------
# ScoringProgram
# ---------------------------------------------------------------------------

_ARRAY_KEYS = ("proj", "thr", "leaf_probs", "feat_mean", "feat_std")


@dataclasses.dataclass(frozen=True)
class ScoringProgram:
    """packed: the dense forest; feat_mean / feat_std: (F,) training
    feature statistics; cfg: the ``PipelineConfig`` it was trained with."""

    packed: forest_ops.PackedForest
    feat_mean: torch.Tensor
    feat_std: torch.Tensor
    cfg: PipelineConfig

    @classmethod
    def from_fitted(cls, fitted: FittedPipeline, cfg: PipelineConfig) -> "ScoringProgram":
        """Lower a trained ``FittedPipeline`` into the serving artifact: the
        one place the serving path packs a forest."""
        return cls(
            packed=rf.pack(fitted.forest),
            feat_mean=fitted.feat_mean,
            feat_std=fitted.feat_std,
            cfg=cfg,
        )

    def _arrays(self) -> dict[str, torch.Tensor]:
        return {
            "proj": self.packed.proj,
            "thr": self.packed.thr,
            "leaf_probs": self.packed.leaf_probs,
            "feat_mean": self.feat_mean,
            "feat_std": self.feat_std,
        }

    def _to_arrays(self) -> dict[str, np.ndarray]:
        """The program as one flat dict in the reference's layout: the
        float32 leaves plus the config as a uint8 JSON leaf."""
        cfg_json = self.cfg._asdict()
        cfg_json["forest"] = self.cfg.forest._asdict()
        arrays = {k: v.detach().cpu().numpy() for k, v in self._arrays().items()}
        arrays["cfg_json"] = np.frombuffer(json.dumps(cfg_json).encode(), dtype=np.uint8)
        return arrays

    @classmethod
    def _from_arrays(cls, arrays: dict, device: torch.device | str) -> "ScoringProgram":
        """Inverse of ``_to_arrays``; leaves may be numpy arrays or tensors."""
        cfg_json = json.loads(np.asarray(arrays["cfg_json"]).tobytes().decode())
        forest_cfg = RotationForestConfig(**cfg_json.pop("forest"))
        cfg = PipelineConfig(forest=forest_cfg, **cfg_json)
        t = {
            k: torch.from_numpy(np.array(arrays[k], dtype=np.float32))
            for k in _ARRAY_KEYS
        }
        n_trees, f, n_leaves = t["proj"].shape
        if (
            t["thr"].shape != (n_trees, n_leaves)
            or t["leaf_probs"].shape[:2] != (n_trees, n_leaves)
            or t["feat_mean"].shape != t["feat_std"].shape
        ):
            raise ValueError(
                "inconsistent program leaves: "
                + ", ".join(f"{k} {tuple(v.shape)}" for k, v in t.items())
            )
        return cls(
            packed=forest_ops.PackedForest(
                proj=t["proj"], thr=t["thr"], leaf_probs=t["leaf_probs"]
            ),
            feat_mean=t["feat_mean"],
            feat_std=t["feat_std"],
            cfg=cfg,
        ).to(device)

    def to(self, device: torch.device | str | None = None) -> "ScoringProgram":
        """The same program with its leaves on ``device`` (as float32), and
        the tables K1 walks derived there."""
        dev = resolve_device(device)
        packed = forest_ops.with_walk_tables(forest_ops.PackedForest(*(
            x.to(device=dev, dtype=torch.float32).contiguous()
            for x in (self.packed.proj, self.packed.thr, self.packed.leaf_probs)
        )))
        return dataclasses.replace(
            self, packed=packed,
            feat_mean=self.feat_mean.to(device=dev, dtype=torch.float32),
            feat_std=self.feat_std.to(device=dev, dtype=torch.float32),
        )

    def save(self, directory: str, step: int = 0) -> str:
        """Write the program under ``directory/step_<step>`` (atomic)."""
        return ckpt_store.save(directory, step, self._to_arrays())

    @classmethod
    def load(
        cls, directory: str, step: int | None = None, *,
        device: torch.device | str | None = None,
    ) -> "ScoringProgram":
        """Restore a saved program (latest step when ``step`` is None) onto
        ``device`` (CUDA by default)."""
        dev = resolve_device(device)
        if step is None:
            step = ckpt_store.latest_step(directory)
            if step is None:
                raise FileNotFoundError(
                    f"no ScoringProgram checkpoints under {directory!r} "
                    "(empty or missing directory)"
                )
        return cls._from_arrays(ckpt_store.restore(directory, step), dev)


# ---------------------------------------------------------------------------
# Device step
# ---------------------------------------------------------------------------

class EngineState(NamedTuple):
    """Per-slot device state (leading axis = slot): the last ``alarm_m``
    chunk votes, the next ring write index, the k-of-m alarm after the
    latest chunk, and the slot's frontend context."""

    rings: torch.Tensor        # (B, m) int32
    ring_pos: torch.Tensor     # (B,) int32
    alarm: torch.Tensor        # (B,) int32
    fe_boundary: torch.Tensor  # (B, max(1, overlap), C, N) float32
    fe_phase: torch.Tensor     # (B,) int32

    def frontend_state(self) -> frontend.FrontendState:
        return frontend.FrontendState(boundary=self.fe_boundary, phase=self.fe_phase)


def init_state(
    max_batch: int,
    alarm_m: int,
    n_channels: int = eeg_data.N_CHANNELS,
    window: int = eeg_data.WINDOW,
    overlap: int = 0,
    *,
    device: torch.device | str,
) -> EngineState:
    fe = frontend.init_batch(max_batch, n_channels, window, overlap, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return EngineState(
        rings=zeros(max_batch, alarm_m), ring_pos=zeros(max_batch),
        alarm=zeros(max_batch), fe_boundary=fe.boundary, fe_phase=fe.phase,
    )


def _vote_chunks(feats, packed, feat_mean, feat_std):
    """(B, W, F) features -> per-chunk (votes (B,), frac (B,), preds
    (B, W)): z-score, run the packed forest, majority-vote each chunk.
    ``argmax`` takes the FIRST maximum on ties, as ``jnp.argmax`` does
    (two classes tie often, e.g. on 0.5/0.5 leaves). The fraction is a
    sum over a division, as ``jnp.mean`` takes it: torch's mean can
    round 30/60 above 0.5 and flip the vote."""
    b, w, f = feats.shape
    normed, _, _ = features.normalize(feats.reshape(b * w, f), feat_mean, feat_std)
    probs = forest_ops.forest_predict_proba(packed, normed)
    preds = torch.argmax(probs, dim=-1).reshape(b, w).to(torch.int32)
    frac = preds.sum(dim=1).to(torch.float32) / w
    votes = (frac > 0.5).to(torch.int32)
    return votes, frac, preds


def _score_chunks(chunks, packed, feat_mean, feat_std, *, cfg):
    """(B, W, C, N) raw chunks -> per-chunk votes/fractions/preds, no state."""
    return _vote_chunks(frontend.chunk_features(chunks, cfg), packed, feat_mean, feat_std)


def _advance_ring(rings, pos, alarm, votes, act, alarm_k):
    """Write each active slot's vote at its ring cursor (the reference's
    ``rings.at[rows, pos].set(v)`` under the same mask) and recompute its
    k-of-m alarm; inactive slots keep everything."""
    m = rings.shape[1]
    rows = torch.arange(rings.shape[0], device=rings.device)
    written = rings.index_put((rows, pos.long()), votes)
    on = act > 0
    rings = torch.where(on[:, None], written, rings)
    pos = torch.where(on, (pos + 1) % m, pos)
    hits = rings.sum(dim=1)
    alarm = torch.where(on, (hits >= alarm_k).to(torch.int32), alarm)
    return rings, pos, alarm


def _engine_step(state, chunks, active, packed, feat_mean, feat_std, *, cfg):
    """The SERIAL oracle: one chunk per slot at a time through
    ``frontend_step`` and the vote, then the ring. chunks (B, D, W, C, N),
    active (B, D) prefix masks. Returns (state, votes, frac, alarm) as
    (B, D) and preds (B, D, W)."""
    d = chunks.shape[1]
    st = state
    outs = []
    for j in range(d):
        act = active[:, j].to(torch.int32)
        fe, feats = frontend.frontend_step(st.frontend_state(), chunks[:, j], cfg)
        votes, frac, preds = _vote_chunks(feats, packed, feat_mean, feat_std)
        votes = votes * act
        rings, pos, alarm = _advance_ring(
            st.rings, st.ring_pos, st.alarm, votes, act, cfg.alarm_k
        )
        on = act > 0
        st = EngineState(
            rings=rings, ring_pos=pos, alarm=alarm,
            fe_boundary=torch.where(on[:, None, None, None], fe.boundary, st.fe_boundary),
            fe_phase=torch.where(on, fe.phase, st.fe_phase),
        )
        outs.append((votes, frac, alarm, preds))
    votes, frac, alarm, preds = (torch.stack(x, dim=1) for x in zip(*outs))
    return st, votes, frac, alarm, preds


def _engine_step_megabatch(state, chunks, active, packed, feat_mean, feat_std, *, cfg):
    """The default step, same contract as ``_engine_step``: the heavy
    stage runs ONCE over the flattened (B*D) chunks (halos taken from the
    backlog itself), and only the alarm ring advances over the D votes.
    ``frac``/``preds`` of padding positions are computed from stale
    buffer contents and never read by the host."""
    b, d = active.shape
    active = active.to(torch.int32)
    fe, feats = frontend.megabatch_step(state.frontend_state(), chunks, active, cfg)
    w = feats.shape[2]
    votes, frac, preds = _vote_chunks(
        feats.reshape(b * d, w, -1), packed, feat_mean, feat_std
    )
    votes = votes.reshape(b, d) * active
    rings, pos, alarm = state.rings, state.ring_pos, state.alarm
    alarms = []
    for j in range(d):
        rings, pos, alarm = _advance_ring(
            rings, pos, alarm, votes[:, j], active[:, j], cfg.alarm_k
        )
        alarms.append(alarm)
    new_state = EngineState(
        rings=rings, ring_pos=pos, alarm=alarm,
        fe_boundary=fe.boundary, fe_phase=fe.phase,
    )
    return new_state, votes, frac.reshape(b, d), torch.stack(alarms, dim=1), preds.reshape(b, d, w)


def _splice_state(state, slot, ring, pos, alarm, boundary, phase) -> None:
    """Write one session's saved ring, cursor, alarm and frontend context
    into slot ``slot``. In place: the reference donates the state buffer
    to this update, so nothing else holds the old values."""
    state.rings[slot] = torch.as_tensor(ring, dtype=torch.int32)
    state.ring_pos[slot] = int(pos)
    state.alarm[slot] = int(alarm)
    state.fe_boundary[slot] = torch.as_tensor(boundary, dtype=torch.float32)
    state.fe_phase[slot] = int(phase)


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of a state row. On the CPU ``.cpu().numpy()`` would be
    a view of the slot, which the next admission overwrites."""
    return t.cpu().numpy().copy()


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------

class StreamSession:
    """One patient's stream handle (from ``SeizureEngine.open_session``).

    ``push`` takes any number of raw windows -- (W, C, N) or one (C, N);
    the session buffers partial chunks and queues each complete
    ``chunk_windows``-window chunk, scored in FIFO order by ``poll``.
    """

    def __init__(self, engine: "SeizureEngine", patient_id: int):
        self._engine = engine
        self.patient_id = patient_id
        # (enqueue time, windows): the time drives the latency budget.
        self.chunks: collections.deque[tuple[float, np.ndarray]] = collections.deque()
        self._buf = np.zeros((0, eeg_data.N_CHANNELS, eeg_data.WINDOW), np.float32)
        # Host copies of the ring and frontend context: authoritative only
        # while the session is NOT resident in a slot.
        self.ring = np.zeros((engine.alarm_m,), np.int32)
        self.ring_pos = 0
        self.alarm = 0
        self.fe_boundary = np.zeros(
            (engine.fe_width, eeg_data.N_CHANNELS, eeg_data.WINDOW), np.float32
        )
        self.fe_phase = 0
        self.chunk_seq = 0
        self.slot: int | None = None
        self.queued = False
        self.closed = False

    def push(self, windows) -> int:
        """Buffer raw windows; returns the number of complete chunks
        waiting to be scored."""
        if self.closed:
            raise RuntimeError(f"session {self.patient_id} is closed")
        if isinstance(windows, torch.Tensor):
            windows = windows.detach().cpu().numpy()
        windows = np.asarray(windows, np.float32)
        if windows.ndim == 2:
            windows = windows[None]
        expect = (eeg_data.N_CHANNELS, eeg_data.WINDOW)
        if windows.ndim != 3 or windows.shape[1:] != expect:
            raise ValueError(
                f"windows shape {windows.shape} != (W, {expect[0]}, {expect[1]})"
            )
        # Copy on adopt: queued chunks are views of _buf and must not
        # alias the caller's buffer.
        self._buf = (
            np.concatenate([self._buf, windows]) if self._buf.size else windows.copy()
        )
        per = self._engine.chunk_windows
        now = self._engine._clock()
        while self._buf.shape[0] >= per:
            self.chunks.append((now, self._buf[:per]))
            self._buf = self._buf[per:]
        if self.chunks:
            self._engine._mark_ready(self)
        return len(self.chunks)

    @property
    def pending_windows(self) -> int:
        """Windows buffered toward the next (incomplete) chunk."""
        return int(self._buf.shape[0])

    @property
    def pending_chunks(self) -> int:
        """Complete chunks waiting to be scored."""
        return len(self.chunks)

    def close(self) -> None:
        self._engine.close_session(self.patient_id)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class SeizureEngine:
    """Continuous-batching multi-patient seizure-scoring engine.

    program          : the ``ScoringProgram`` to serve (moved to ``device``).
    max_batch        : device slots.
    chunk_windows    : windows per chunk (the paper's 60).
    replay_depth     : backlogged chunks one step scores per slot; every
                       step pads to this depth.
    megabatch        : True runs the batched heavy stage; False the serial
                       per-chunk oracle. Events are equal either way.
    latency_budget_s : ``poll(drain=False)`` flushes a partial batch once
                       the oldest queued chunk has waited this long.
    clock            : monotonic time source for the budget.
    device           : CUDA by default; ``"cpu"`` runs the plain versions.

    Each slot is bound to at most one session; after every step, slots
    whose session has nothing ready are freed and refilled from the
    waiting queue, carrying the ring and frontend context across.
    """

    def __init__(
        self,
        program: ScoringProgram,
        *,
        max_batch: int = 8,
        chunk_windows: int = eeg_data.WINDOWS_PER_MATRIX,
        replay_depth: int = 1,
        megabatch: bool = True,
        latency_budget_s: float | None = None,
        clock=time.monotonic,
        device: torch.device | str | None = None,
    ):
        if replay_depth < 1:
            raise ValueError(f"replay_depth={replay_depth} must be >= 1")
        check_supported(program.cfg)
        self.device = resolve_device(device)
        self.program = self._install_program(program)
        self.max_batch = max_batch
        self.chunk_windows = chunk_windows
        self.replay_depth = replay_depth
        self.megabatch = megabatch
        self.latency_budget_s = latency_budget_s
        self.alarm_m = program.cfg.alarm_m
        self.fe_width = frontend.boundary_width(program.cfg.overlap)
        self.steps = 0  # device steps run (scheduling observability)
        self.program_version = 0
        self._clock = clock
        self._step = _engine_step_megabatch if megabatch else _engine_step
        self._sessions: dict[int, StreamSession] = {}
        self._slots: list[StreamSession | None] = [None] * max_batch
        self._waiting: collections.deque[StreamSession] = collections.deque()
        self._state = init_state(
            max_batch, self.alarm_m, overlap=program.cfg.overlap, device=self.device
        )

    # -- program install / hot-swap ------------------------------------------

    def _install_program(self, program: ScoringProgram) -> ScoringProgram:
        """The program with contiguous float32 leaves on the engine's
        device: the one path both the constructor and ``swap_program`` take."""
        return program.to(self.device)

    def swap_program(self, new_program: ScoringProgram, *, version: int | None = None) -> int:
        """Install a retrained ``ScoringProgram`` into the RUNNING engine,
        with no session drained: alarm rings and frontend context stay,
        and the next ``poll`` scores with the new forest, every
        ``ChunkScored`` from then on carrying the new ``program_version``.
        A program whose config or leaf shapes and types differ from the
        serving one is refused with a ``ValueError`` before anything
        changes (it needs a new engine, as in the reference).

        Returns the now-serving version (``version`` if given, else the
        running version + 1).
        """
        if new_program.cfg != self.program.cfg:
            raise ValueError(
                "swap_program: new program's PipelineConfig differs from "
                f"the serving one ({new_program.cfg} != {self.program.cfg}); "
                "open a new engine instead"
            )
        old, new = self.program._arrays(), new_program._arrays()
        mismatched = [
            f"{k}: {tuple(new[k].shape)}/{new[k].dtype} != "
            f"{tuple(old[k].shape)}/{old[k].dtype}"
            for k in old
            if tuple(new[k].shape) != tuple(old[k].shape) or new[k].dtype != old[k].dtype
        ]
        if mismatched:
            raise ValueError(
                "swap_program: packed shapes must match the serving program; "
                "mismatched leaves: " + "; ".join(mismatched)
            )
        self.program = self._install_program(new_program)
        self.program_version = self.program_version + 1 if version is None else int(version)
        return self.program_version

    # -- sessions ------------------------------------------------------------

    def open_session(self, patient_id: int) -> StreamSession:
        patient_id = int(patient_id)
        if patient_id in self._sessions:
            raise ValueError(f"session for patient {patient_id} already open")
        session = StreamSession(self, patient_id)
        self._sessions[patient_id] = session
        return session

    def session(self, patient_id: int) -> StreamSession | None:
        return self._sessions.get(int(patient_id))

    def close_session(self, patient_id: int) -> None:
        """Drop a session and its alarm state (unscored chunks included)."""
        session = self._sessions.pop(int(patient_id), None)
        if session is None:
            return
        if session.slot is not None:
            self._slots[session.slot] = None
            session.slot = None
        if session.queued:
            self._waiting.remove(session)
            session.queued = False
        session.closed = True

    def alarm_state(self, patient_id: int) -> int:
        """Current k-of-m alarm state (0 if the patient is unknown)."""
        session = self._sessions.get(int(patient_id))
        return int(session.alarm) if session is not None else 0

    def reset_alarm(self, patient_id: int) -> None:
        """Zero a session's alarm ring, keeping its queued and buffered
        windows and its stream context."""
        session = self._sessions.get(int(patient_id))
        if session is None:
            return
        if session.slot is not None:
            # The device copy of the frontend context is authoritative
            # while resident: pull it so the re-splice keeps it.
            self._sync_frontend(session.slot, session)
        session.ring = np.zeros((self.alarm_m,), np.int32)
        session.ring_pos = 0
        session.alarm = 0
        if session.slot is not None:
            self._admit(session.slot, session)

    def _mark_ready(self, session: StreamSession) -> None:
        if session.slot is None and not session.queued:
            self._waiting.append(session)
            session.queued = True

    # -- slot scheduling -----------------------------------------------------

    def _sync_frontend(self, slot: int, session: StreamSession) -> None:
        """Pull the slot's device frontend context into the session."""
        session.fe_boundary = _host_copy(self._state.fe_boundary[slot])
        session.fe_phase = int(self._state.fe_phase[slot])

    def _evict(self, slot: int) -> None:
        """Pull the slot's device stream state back into its session."""
        session = self._slots[slot]
        session.ring = _host_copy(self._state.rings[slot])
        session.ring_pos = int(self._state.ring_pos[slot])
        session.alarm = int(self._state.alarm[slot])
        self._sync_frontend(slot, session)
        session.slot = None
        self._slots[slot] = None

    def _admit(self, slot: int, session: StreamSession) -> None:
        """Splice the session's saved ring and frontend context into the slot."""
        _splice_state(
            self._state, slot, session.ring, session.ring_pos, session.alarm,
            session.fe_boundary, session.fe_phase,
        )
        session.slot = slot
        session.queued = False
        self._slots[slot] = session

    def _fill_slots(self) -> None:
        for i in range(self.max_batch):
            occupant = self._slots[i]
            if occupant is not None and not occupant.chunks and self._waiting:
                self._evict(i)  # a drained session yields its slot
            if self._slots[i] is None and self._waiting:
                self._admit(i, self._waiting.popleft())

    # -- serving -------------------------------------------------------------

    def _deadline_exceeded(self) -> bool:
        """True iff a latency budget is set and the OLDEST queued chunk
        (any session) has outlived it."""
        if self.latency_budget_s is None:
            return False
        oldest = min(
            (s.chunks[0][0] for s in self._sessions.values() if s.chunks),
            default=None,
        )
        return oldest is not None and self._clock() - oldest >= self.latency_budget_s

    def poll(self, *, drain: bool = True) -> list:
        """Score ready chunks and return the events. drain=True scores
        everything ready (a final partial batch included); drain=False
        runs only full batches, unless the latency budget has expired."""
        events: list = []
        while True:
            self._fill_slots()
            active = [i for i, s in enumerate(self._slots) if s is not None and s.chunks]
            if not active:
                break
            if (
                not drain
                and len(active) < self.max_batch
                and not self._deadline_exceeded()
            ):
                break
            events.extend(self._step_once(active))
        return events

    def _step_once(self, active: list[int]) -> list:
        depth = self.replay_depth
        batch = np.zeros(
            (self.max_batch, depth, self.chunk_windows, eeg_data.N_CHANNELS,
             eeg_data.WINDOW),
            np.float32,
        )
        mask = np.zeros((self.max_batch, depth), np.int32)
        popped: dict[int, int] = {}
        for i in active:
            session = self._slots[i]
            take = min(depth, len(session.chunks))
            for j in range(take):
                _, batch[i, j] = session.chunks.popleft()
                mask[i, j] = 1
            popped[i] = take
        program = self.program
        self._state, votes, frac, alarm, preds = self._step(
            self._state,
            torch.from_numpy(batch).to(self.device),
            torch.from_numpy(mask).to(self.device),
            program.packed, program.feat_mean, program.feat_std,
            cfg=program.cfg,
        )
        self.steps += 1
        votes, frac, alarm, preds = (x.cpu().numpy() for x in (votes, frac, alarm, preds))
        events: list = []
        for i in active:
            session = self._slots[i]
            for j in range(popped[i]):
                prev_alarm, session.alarm = session.alarm, int(alarm[i, j])
                events.append(ChunkScored(
                    patient_id=session.patient_id,
                    chunk_index=session.chunk_seq,
                    chunk_pred=int(votes[i, j]),
                    preictal_frac=float(frac[i, j]),
                    alarm=session.alarm,
                    window_preds=np.asarray(preds[i, j]),
                    program_version=self.program_version,
                ))
                if session.alarm > prev_alarm:
                    events.append(AlarmRaised(session.patient_id, session.chunk_seq))
                elif session.alarm < prev_alarm:
                    events.append(AlarmCleared(session.patient_id, session.chunk_seq))
                session.chunk_seq += 1
        return events

    def score_chunks(self, chunks) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Stateless: an assembled (B, W, C, N) batch -> (votes (B,),
        preictal_frac (B,), window_preds (B, W)) on the engine's device,
        touching no session's ring."""
        program = self.program
        chunks = torch.as_tensor(chunks, dtype=torch.float32, device=self.device)
        return _score_chunks(
            chunks, program.packed, program.feat_mean, program.feat_std, cfg=program.cfg
        )
