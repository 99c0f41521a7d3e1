"""The port's scoring program, checkpoint store and engine against the
JAX reference on the CPU.

Both packages serve the committed full-width program
(``src/repro_torch/assets/seizure_program``, written by
``tests/make_torch_port_program.py``) on the same JAX-generated chunks.
Events must agree exactly in type, patient, chunk index, ``chunk_pred``
and ``alarm``; a window prediction may differ only where the JAX-side
routing margin ``min |x . proj - thr|`` along the window's path is below
1e-3 in z-units (the float32 denoise/feature differences between the
packages are ~5e-4 z-units at worst), and the test checks every such
mismatch against that margin.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.kernels.forest import ops as jforest_ops
from repro.serving import api as japi
from repro.signal import eeg_data as jeeg
from repro.signal import frontend as jfrontend
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.kernels.forest import ops as forest_ops
from repro_torch.serving import api
from repro_torch.signal import frontend

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.append(str(ROOT))  # chip_smoke.py, which loads the example scripts
load_example = importlib.import_module("chip_smoke").load_example

# One intra-op thread: the suite runs in parallel workers on a shared
# machine, where OpenMP barriers across two threads stall far longer
# than one thread takes to do the work alone.
torch.set_num_threads(1)

PROGRAM_DIR = str(
    pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "assets"
    / "seizure_program"
)
PER = 60


@pytest.fixture(scope="module")
def jprogram():
    return japi.ScoringProgram.load(PROGRAM_DIR)


# ---------------------------------------------------------------------------
# Program and checkpoint layout
# ---------------------------------------------------------------------------

def _assert_same_program(tp: api.ScoringProgram, jp: japi.ScoringProgram) -> None:
    for k, v in tp._arrays().items():
        np.testing.assert_array_equal(v.cpu().numpy(), np.asarray(jp._arrays()[k]))
    assert tp.cfg._asdict() | {"forest": tp.cfg.forest._asdict()} == (
        jp.cfg._asdict() | {"forest": jp.cfg.forest._asdict()}
    )


def test_committed_program_loads_equal(jprogram):
    program = api.ScoringProgram.load(PROGRAM_DIR, device="cpu")
    _assert_same_program(program, jprogram)
    assert program.packed.proj.shape == (10, 288, 64)
    assert program.cfg == api.PipelineConfig()


def test_port_save_loads_through_jax(jprogram, tmp_path):
    program = api.ScoringProgram.load(PROGRAM_DIR, device="cpu")
    program.save(str(tmp_path / "prog"), step=3)
    _assert_same_program(program, japi.ScoringProgram.load(str(tmp_path / "prog")))


def test_convert_round_trip(jprogram):
    arrays = jprogram._to_arrays()
    program = convert.program_from_jax_arrays(arrays, device="cpu")
    _assert_same_program(program, jprogram)
    back = convert.program_to_jax_arrays(program)
    assert back.keys() == arrays.keys()
    for k in arrays:  # cfg_json included, byte for byte
        np.testing.assert_array_equal(back[k], np.asarray(arrays[k]))
    _assert_same_program(program, japi.ScoringProgram._from_arrays(back))


def test_store_layout_matches_jax(tmp_path):
    """bf16 as uint16 bits, nested keys, both directions, and the temp-dir
    sweep of ``latest_step``."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "nest": {"b": np.arange(5, dtype=np.int32)}}
    bf = jnp.asarray(rng.normal(size=(6,)), jnp.bfloat16)
    jstore.save(str(tmp_path / "j"), 2, dict(tree, bf=bf))
    got = store.restore(str(tmp_path / "j"), 2)
    assert set(got) == {"a", "nest/b", "bf"}
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"])
    np.testing.assert_array_equal(got["nest/b"].numpy(), tree["nest"]["b"])
    assert got["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf"].float().numpy(), np.asarray(bf, np.float32))

    store.save(str(tmp_path / "t"), 5, {"a": torch.from_numpy(tree["a"]),
                                         "nest": {"b": tree["nest"]["b"]},
                                         "bf": got["bf"]})
    like = jstore.manifest_like(str(tmp_path / "t"), 5)
    back = jstore.restore(str(tmp_path / "t"), 5, like)
    np.testing.assert_array_equal(np.asarray(back["bf"]), np.asarray(bf))
    np.testing.assert_array_equal(np.asarray(back["nest/b"]), tree["nest"]["b"])

    os.makedirs(tmp_path / "t" / ".tmp_ckpt_dead")
    os.makedirs(tmp_path / "t" / "step_bogus")
    assert store.latest_step(str(tmp_path / "t")) == 5
    assert not (tmp_path / "t" / ".tmp_ckpt_dead").exists()
    assert store.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        store.restore(str(tmp_path / "t"), 6)


# ---------------------------------------------------------------------------
# Device rule
# ---------------------------------------------------------------------------

def test_manifest_like_matches_jax(jprogram, tmp_path, monkeypatch):
    """On a JAX-saved program (and a bf16 leaf) the port's manifest_like
    gives the reference's shapes and dtypes, and a program whose manifest
    does not form one forest is refused before any array is read."""
    jprogram.save(str(tmp_path / "j"), step=2)
    jstore.save(str(tmp_path / "bf"), 0, {"w": jnp.ones((2, 3), jnp.bfloat16)})
    for directory, step in ((tmp_path / "j", 2), (tmp_path / "bf", 0)):
        got = store.manifest_like(str(directory), step)
        want = jstore.manifest_like(str(directory), step)
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].shape == tuple(w.shape)
            assert str(got[k].dtype).removeprefix("torch.") == str(np.dtype(w.dtype))
    assert set(got) == {"w"} and got["w"].dtype == torch.bfloat16

    arrays = store.restore(str(tmp_path / "j"), 2)
    store.save(str(tmp_path / "bad"), 0, dict(arrays, thr=arrays["thr"][:, :3]))

    def no_read(*args):
        raise AssertionError("an array was read before the manifest check")

    monkeypatch.setattr(store, "restore", no_read)
    with pytest.raises(ValueError, match="inconsistent program leaves"):
        api.ScoringProgram.load(str(tmp_path / "bad"), device="cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.ScoringProgram.load(PROGRAM_DIR)
    program = api.ScoringProgram.load(PROGRAM_DIR, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.SeizureEngine(program)
    with pytest.raises(RuntimeError):
        convert.program_from_jax_arrays(program._to_arrays())
    engine = api.SeizureEngine(program, max_batch=1, device="cpu")
    assert engine.device.type == "cpu" and engine.program.feat_mean.device.type == "cpu"


def test_restore_and_streaming_frontend_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.SeizureEngine.restore(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        frontend.StreamingFrontend(api.PipelineConfig())
    assert frontend.StreamingFrontend(api.PipelineConfig(), device="cpu").chunks_seen == 0


# ---------------------------------------------------------------------------
# Voting: argmax ties go to the first class, as in jnp.argmax
# ---------------------------------------------------------------------------

def test_vote_argmax_ties_take_first_class():
    rng = np.random.default_rng(1)
    n_trees, f, n_leaves = 2, 6, 4
    proj = rng.normal(size=(n_trees, f, n_leaves)).astype(np.float32)
    thr = rng.normal(size=(n_trees, n_leaves)).astype(np.float32)
    leaf = np.full((n_trees, n_leaves, 2), 0.5, np.float32)  # every leaf ties
    leaf[0, 0] = [0.25, 0.75]
    feats = rng.normal(size=(3, 20, f)).astype(np.float32)
    mean, std = np.zeros(f, np.float32), np.ones(f, np.float32)

    jpacked = jforest_ops.PackedForest(*map(jnp.asarray, (proj, thr, leaf)))
    jv, jf, jp = (np.asarray(v) for v in japi._vote_chunks(
        jnp.asarray(feats), jpacked, jnp.asarray(mean), jnp.asarray(std), use_pallas=False
    ))
    packed = forest_ops.PackedForest(*map(torch.from_numpy, (proj, thr, leaf)))
    tv, tf, tp = (v.numpy() for v in api._vote_chunks(
        torch.from_numpy(feats), packed, torch.from_numpy(mean), torch.from_numpy(std)
    ))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tv, jv)
    # jnp.mean on the CPU multiplies by fl(1/W) where the port divides
    # (correctly rounded, so 30/60 is exactly 0.5): up to 1 ulp apart.
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-6)
    probs = forest_ops.forest_predict_proba(packed, torch.from_numpy(feats.reshape(-1, f)))
    tied = (probs[:, 0] == probs[:, 1]).numpy().reshape(tp.shape)
    assert tied.sum() >= 10 and (tp[tied] == 0).all() and (tp[~tied] == 1).all()


# ---------------------------------------------------------------------------
# Engine events, port vs JAX
# ---------------------------------------------------------------------------

# Three patients on two slots (eviction churn): chunk regimes in order.
_STREAMS = {3: (jeeg.INTERICTAL, jeeg.PREICTAL, jeeg.INTERICTAL),
            8: (jeeg.INTERICTAL, jeeg.PREICTAL, jeeg.PREICTAL),
            13: (jeeg.PREICTAL, jeeg.INTERICTAL, jeeg.PREICTAL)}
_CUTS = (0, 37, 95, 151, 180)  # chunk-unaligned push boundaries


@pytest.fixture(scope="module")
def streams():
    out = {}
    for i, (pid, regimes) in enumerate(_STREAMS.items()):
        out[pid] = np.concatenate([
            np.asarray(jeeg.generate_windows(
                jax.random.PRNGKey(100 + 10 * i + j), jnp.asarray(pid), r, PER
            ))
            for j, r in enumerate(regimes)
        ])
    return out


def _run(mod, program, streams, **kw):
    engine, head = _start(mod, program, streams, None, **kw)
    return head + _resume(engine, streams)


# Snapshots are taken after the third push, before its poll: patients 13
# and 8 then hold the two slots with chunks queued, and patient 3 waits.
_SNAP_ROUND = 2


def _start(mod, program, streams, snapshot_dir, **kw):
    """Open a two-slot engine and run ``_CUTS``'s push rounds up to and
    including the push of round _SNAP_ROUND (snapshotting into
    ``snapshot_dir`` there, if given). Returns the engine and the events so
    far (the head)."""
    engine = mod.SeizureEngine(program, max_batch=2, **kw)
    sessions = {pid: engine.open_session(pid) for pid in streams}
    head = []
    for r, (lo, hi) in enumerate(zip(_CUTS[:-1], _CUTS[1:])):
        for pid, s in sessions.items():
            s.push(streams[pid][lo:hi])
        if r == _SNAP_ROUND:
            if snapshot_dir is not None:
                engine.snapshot(snapshot_dir, step=7)
            return engine, head
        head += engine.poll(drain=False)


def _resume(engine, streams):
    """The rest of the schedule from the snapshot point (the tail)."""
    events = engine.poll(drain=False)
    for lo, hi in zip(_CUTS[_SNAP_ROUND + 1:-1], _CUTS[_SNAP_ROUND + 2:]):
        for pid in streams:
            engine.session(pid).push(streams[pid][lo:hi])
        events += engine.poll(drain=False)
    return events + engine.poll()


def _jax_margins(jp, stream, k):
    """(60,) JAX-side routing margin of chunk k's windows, in z-units."""
    ov = jp.cfg.overlap
    chunk = stream[k * PER:(k + 1) * PER]
    halo = None
    if ov:
        halo = (stream[k * PER - ov:k * PER] if k else np.zeros((ov,) + chunk.shape[1:], np.float32))
        halo = jnp.asarray(halo)
    feats = np.asarray(jfrontend.chunk_features(jnp.asarray(chunk), jp.cfg, halo=halo))
    x = (feats - np.asarray(jp.feat_mean)) / np.asarray(jp.feat_std)
    proj, thr = np.asarray(jp.packed.proj), np.asarray(jp.packed.thr)
    depth = proj.shape[-1].bit_length() - 1
    out = np.full(PER, np.inf)
    rows = np.arange(PER)
    for t in range(proj.shape[0]):
        vals = x @ proj[t]
        node = np.ones(PER, np.int64)
        for _ in range(depth):
            v, th = vals[rows, node], thr[t, node]
            out = np.minimum(out, np.where(np.isfinite(th), np.abs(v - th), np.inf))
            node = 2 * node + (v > th)
    return out


def _assert_events_match(got, want, jp, streams):
    assert [type(e).__name__ for e in got] == [type(e).__name__ for e in want]
    for g, w in zip(got, want):
        if isinstance(w, japi.ChunkScored):
            assert (g.patient_id, g.chunk_index, g.chunk_pred, g.alarm) == (
                w.patient_id, w.chunk_index, w.chunk_pred, w.alarm)
            bad = np.flatnonzero(g.window_preds != w.window_preds)
            if bad.size:
                margins = _jax_margins(jp, streams[w.patient_id], w.chunk_index)
                assert (margins[bad] < 1e-3).all(), margins[bad]
            else:
                assert abs(g.preictal_frac - w.preictal_frac) < 1e-6
        else:
            assert tuple(g) == tuple(w)


def _by_patient(events):
    out = {}
    for e in events:
        out.setdefault(e.patient_id, []).append(e)
    return out


# Each (overlap, alarm rule) pair is served at replay depths 1 and 3
# against ONE JAX run at depth 3: the JAX engine's events per patient do
# not depend on the depth (pinned bit for bit by its own replay tests),
# and a JAX run of the full-width step is the costliest part of this
# file. At depth 3 the whole event sequence must match; at depth 1, where
# the engine interleaves the patients differently by design, each
# patient's own sequence must.
@pytest.fixture(scope="module")
def jax_events(jprogram, streams):
    cache = {}

    def events(overlap, alarm):
        if (overlap, alarm) not in cache:
            cfg = jprogram.cfg._replace(
                overlap=overlap, alarm_k=alarm[0], alarm_m=alarm[1]
            )
            jp = japi.ScoringProgram(
                jprogram.packed, jprogram.feat_mean, jprogram.feat_std, cfg
            )
            cache[overlap, alarm] = jp, _run(japi, jp, streams, replay_depth=3)
        return cache[overlap, alarm]

    return events


_ALARM = {0: (3, 5), 2: (1, 1)}  # the alarm rule served at each overlap


def _port_program(jp, **cfg):
    program = convert.program_from_jax_arrays(jp._to_arrays(), device="cpu")
    return dataclasses.replace(program, cfg=program.cfg._replace(**cfg)) if cfg else program


@pytest.fixture(scope="module")
def port_runs(jax_events, streams, tmp_path_factory):
    """The port's runs on the CPU, one per (overlap, depth, megabatch),
    each computed once for the file: (snapshot dir, head, tail). Each run's
    engine snapshots itself at the snapshot point and runs on (a snapshot
    leaves the engine as it was: test_snapshot_leaves_the_engine_unchanged)."""
    cache = {}

    def run(overlap, depth=3, megabatch=True):
        key = overlap, depth, megabatch
        if key not in cache:
            jp, _ = jax_events(overlap, _ALARM[overlap])
            directory = str(tmp_path_factory.mktemp("engine_snapshot"))
            engine, head = _start(api, _port_program(jp), streams, directory,
                                  replay_depth=depth, megabatch=megabatch, device="cpu")
            cache[key] = directory, head, _resume(engine, streams)
        return cache[key]

    return run


@pytest.fixture(scope="module")
def port_events(port_runs):
    """The port's uninterrupted events for (overlap, depth, megabatch)."""
    def events(overlap, depth=3, megabatch=True):
        _, head, tail = port_runs(overlap, depth, megabatch)
        return head + tail

    return events


@pytest.mark.parametrize("depth,overlap,alarm", [
    (1, 0, (3, 5)), (3, 0, (3, 5)), (1, 2, (1, 1)), (3, 2, (1, 1)),
])
def test_engine_events_match_jax(jax_events, port_events, streams, depth, overlap, alarm):
    assert alarm == _ALARM[overlap]
    jp, want = jax_events(overlap, alarm)
    got = port_events(overlap, depth)
    assert sum(isinstance(e, api.ChunkScored) for e in got) == 9
    kinds = {type(e).__name__ for e in got}
    assert "AlarmRaised" in kinds and ("AlarmCleared" in kinds) == (alarm == (1, 1))
    if depth == 3:
        _assert_events_match(got, want, jp, streams)
        # the port's serial oracle emits the same events
        _assert_events_match(port_events(overlap, depth, megabatch=False), want, jp, streams)
    else:
        got_p, want_p = _by_patient(got), _by_patient(want)
        assert got_p.keys() == want_p.keys() == streams.keys()
        for pid in streams:
            _assert_events_match(got_p[pid], want_p[pid], jp, streams)


def test_reference_kernels_leg_emits_the_default_events(jax_events, streams):
    """The reference_kernels leg (gather-form analysis level by level,
    sample-major PCA with the masked reconstruction, scatter-add
    synthesis) serves the same events as the default leg."""
    jp, want = jax_events(0, _ALARM[0])
    got = _run(api, _port_program(jp, reference_kernels=True), streams, replay_depth=3,
               device="cpu")
    _assert_events_match(got, want, jp, streams)


def test_serve_example_gives_the_jax_engine_events(jax_events, streams, monkeypatch):
    """examples/serve_seizure_torch.py's serving loop on the file's carried
    program and JAX streams, at 2 slots and replay depth 3 with pushes of
    25 windows: every poll drains, so each patient's events do not depend
    on how the pushes are cut, and each equals the patient's events of the
    file's JAX engine run (its own cuts, depth 3) by the file's rule; the
    final alarm states are the last chunks' alarms. Without ``device`` the
    example needs a card."""
    ex = load_example("serve_seizure_torch")
    jp, want = jax_events(0, _ALARM[0])
    got = ex.serve(_port_program(jp), streams, batch=2, push_windows=25, replay_depth=3,
                   device="cpu", log=lambda *a: None)
    got_p, want_p = _by_patient(got["events"]), _by_patient(want)
    assert got_p.keys() == want_p.keys() == streams.keys() and got["chunks"] == 9
    for pid in streams:
        _assert_events_match(got_p[pid], want_p[pid], jp, streams)
        last = [e for e in want_p[pid] if isinstance(e, japi.ChunkScored)][-1]
        assert got["final_alarms"][pid] == last.alarm
        assert got["served"][pid]["alarms"] == [
            e.alarm for e in want_p[pid] if isinstance(e, japi.ChunkScored)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.main(["--patients", "1"])


# ---------------------------------------------------------------------------
# Snapshot / restore
# ---------------------------------------------------------------------------

def _assert_identical(got, want):
    """Byte-identical events: every field, window predictions and
    ``preictal_frac`` included."""
    assert [type(e).__name__ for e in got] == [type(e).__name__ for e in want]
    for g, w in zip(got, want):
        if isinstance(w, (api.ChunkScored, japi.ChunkScored)):
            assert g[:5] + (g.program_version,) == w[:5] + (w.program_version,)
            np.testing.assert_array_equal(g.window_preds, w.window_preds)
        else:
            assert tuple(g) == tuple(w)


def test_snapshot_leaves_the_engine_unchanged(jax_events, port_events, streams):
    jp, _ = jax_events(2, _ALARM[2])
    _assert_identical(_run(api, _port_program(jp), streams, replay_depth=3, device="cpu"),
                      port_events(2))


@pytest.mark.parametrize("overlap", [0, 2])
@pytest.mark.parametrize("megabatch", [True, False])
def test_snapshot_restore_within_port(port_runs, streams, overlap, megabatch):
    """Restored, the engine's tail is byte-identical to the live engine's,
    so head + tail is the uninterrupted run."""
    directory, head, live_tail = port_runs(overlap, megabatch=megabatch)
    engine = api.SeizureEngine.restore(directory, device="cpu")
    assert (engine.megabatch, engine.fe_width) == (megabatch, max(1, overlap))
    assert [s and s.patient_id for s in engine._slots] == [13, 8]
    assert [s.patient_id for s in engine._waiting] == [3] and engine.session(3).queued
    assert engine.steps > 0 and engine.session(13).pending_chunks == 2
    _assert_identical(_resume(engine, streams), live_tail)


def test_megabatch_snapshot_restores_into_the_serial_step(port_runs, port_events,
                                                          jax_events, streams):
    """The snapshot holds votes and raw windows only, so the serial step
    resumed from a megabatch snapshot continues exactly as an uninterrupted
    serial engine."""
    directory, head, _ = port_runs(2)
    engine = api.SeizureEngine.restore(directory, megabatch=False, clock=lambda: 1e6,
                                       device="cpu")
    # Queued chunks keep their ages, rebased onto the new clock.
    stamps = [t for s in engine._sessions.values() for t, _ in s.chunks]
    assert len(stamps) == 4 and all(1e6 - 60 < t <= 1e6 for t in stamps)
    tail = _resume(engine, streams)
    _assert_identical(tail, port_events(2, megabatch=False)[len(head):])
    jp, want = jax_events(2, _ALARM[2])
    _assert_events_match(tail, want[len(head):], jp, streams)


def test_jax_snapshot_restores_in_port(jax_events, streams, tmp_path):
    jp, want = jax_events(0, _ALARM[0])
    _, head = _start(japi, jp, streams, str(tmp_path), replay_depth=3)
    engine = api.SeizureEngine.restore(str(tmp_path), device="cpu")
    _assert_events_match(_resume(engine, streams), want[len(head):], jp, streams)


def test_port_snapshot_restores_in_jax(port_runs, jax_events, streams):
    directory, head, _ = port_runs(2)
    jp, want = jax_events(2, _ALARM[2])
    engine = japi.SeizureEngine.restore(directory)
    assert engine.replay_depth == 3 and not engine.use_forest_kernel
    _assert_events_match(_resume(engine, streams), want[len(head):], jp, streams)


def test_restore_errors(port_runs, tmp_path):
    for missing in (tmp_path / "missing", tmp_path / "empty"):
        if missing.name == "empty":
            missing.mkdir()
        with pytest.raises(FileNotFoundError, match="no engine snapshots"):
            api.SeizureEngine.restore(str(missing), device="cpu")
    directory, _, _ = port_runs(2)
    arrays = store.restore(directory, 7)

    def resave(name, **leaves):
        store.save(str(tmp_path / name), 0, dict(arrays, **leaves))
        return str(tmp_path / name)

    host = json.loads(arrays["host_json"].numpy().tobytes())
    host["format"] = 2
    bad = resave("format", host_json=np.frombuffer(json.dumps(host).encode(), np.uint8))
    with pytest.raises(ValueError, match="format 2"):
        api.SeizureEngine.restore(bad, device="cpu")
    # A boundary one window wide is what an overlap-0 engine carries.
    bad = resave("width", state__fe_boundary=arrays["state__fe_boundary"][:, :1])
    with pytest.raises(ValueError, match="fe_boundary"):
        api.SeizureEngine.restore(bad, device="cpu")
    bad = resave("session", sess00000003__fe_boundary=arrays["sess00000003__fe_boundary"][:1])
    with pytest.raises(ValueError, match="session 3"):
        api.SeizureEngine.restore(bad, device="cpu")


def test_engine_session_lifecycle_cpu(streams):
    """score_chunks is stateless, reset_alarm keeps queued windows, and a
    closed session refuses pushes."""
    program = api.ScoringProgram.load(PROGRAM_DIR, device="cpu")
    engine = api.SeizureEngine(program, max_batch=1, device="cpu",
                               latency_budget_s=0.0, clock=lambda: 0.0)
    s = engine.open_session(8)
    s.push(streams[8][:90])
    assert (s.pending_chunks, s.pending_windows) == (1, 30)
    events = engine.poll(drain=False)  # the latency budget flushes it
    assert [type(e).__name__ for e in events] == ["ChunkScored"]
    votes, frac, preds = engine.score_chunks(streams[8][None, :PER])
    assert votes.shape == (1,) and preds.shape == (1, PER)
    np.testing.assert_array_equal(preds[0].numpy(), events[0].window_preds)
    engine.reset_alarm(8)
    assert engine.alarm_state(8) == 0 and s.pending_windows == 30
    s.close()
    with pytest.raises(RuntimeError):
        s.push(streams[8][:1])
