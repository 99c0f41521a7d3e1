"""The port's signal stage against the JAX reference on the CPU.

Inputs are numpy-seeded (or drawn from the JAX generator) and handed to
both packages as numpy arrays. Tolerances, with their reasons:
  * wavelet levels: max abs <= 1e-5 * max|x| and relative Frobenius
    <= 1e-5 -- the same 8 float32 taps summed in another order.
  * PCA: compared by reconstruction (eigenvector bases of degenerate
    eigenvalues are solver-dependent; the kept subspace is not),
    relative Frobenius <= 1e-4, eigenvalues to 1e-4 of the largest.
  * MSPCA denoise: relative Frobenius <= 1e-4 (measured ~1.4e-5 at full
    width): LAPACK's and XLA's eigensolvers agree to float32 rounding on
    the kept subspace, and 5 levels of filtering add a few ulps each.
  * WPD features: compared in z-units (difference / per-feature std),
    <= 2e-3 (measured ~5e-4). Relative error is meaningless for
    features near zero, e.g. the skew of a symmetric node.
  * EEG generator: only statistics can match (the port draws from a
    torch.Generator): per-band power within 12% of the reference's,
    averaged over 32 draws of the per-call phases (the preictal theta
    band interferes with a common-phase copy of itself, so its power
    depends on the phase draw; 3 seed sets measured within 6%).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pca as jpca
from repro.signal import eeg_data as jeeg
from repro.signal import features as jfeatures
from repro.signal import frontend as jfrontend
from repro.signal import mspca as jmspca
from repro.signal import pipeline as jpipeline
from repro.signal import wavelet as jwavelet
from repro_torch.core import pca
from repro_torch.signal import eeg_data, features, frontend, mspca, pipeline, wavelet

# One intra-op thread: the suite runs in parallel workers on a shared
# machine, where OpenMP barriers across two threads stall far longer
# than one thread takes to do the work alone.
torch.set_num_threads(1)

CFG = pipeline.PipelineConfig()
JCFG = jpipeline.PipelineConfig()


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, want, rel: float) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()
    assert np.linalg.norm(got - want) <= rel * np.linalg.norm(want)


def _z_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    flat = want.reshape(-1, want.shape[-1])
    return float((np.abs(got - want) / (flat.std(0) + 1e-6)).max())


@pytest.fixture(scope="module")
def chunk():
    """One full-width raw chunk (60, 3, 2048) from the JAX generator."""
    return np.asarray(jeeg.generate_windows(
        jax.random.PRNGKey(11), jnp.asarray(3), jeeg.PREICTAL, 60
    ))


@pytest.fixture(scope="module")
def small_stream():
    """Five 60-window chunks at N = 512 samples: enough for MSPCA's 5
    levels and WPD's 4, at a quarter of the full width's cost."""
    rng = np.random.default_rng(7)
    base = rng.normal(size=(300, 3, 512)).astype(np.float32)
    return base + np.sin(np.arange(512) / 5.0, dtype=np.float32) * rng.normal(size=(300, 3, 1))


# ---------------------------------------------------------------------------
# wavelet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["db1", "db2", "db4"])
def test_filters_match(name):
    for got, want in zip(wavelet.filters(name), jwavelet.filters(name)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_levels(x, name, levels):
    """Every level's (a, d, synthesis, scatter synthesis), in one compile."""
    out = []
    for _ in range(levels):
        a, d = jwavelet.analysis_step(x, name)
        out.append((a, d, jwavelet.synthesis_step(a, d, name),
                    jwavelet.synthesis_step_reference(a, d, name)))
        x = a
    return out


@pytest.mark.parametrize("name", ["db2", "db4"])
def test_analysis_and_synthesis_each_level(name):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 3, 256)).astype(np.float32)
    cur = _t(x)
    for ja, jd, jsyn, jsyn_ref in _jax_levels(jnp.asarray(x), name, 5):
        a, d = wavelet.analysis_step(cur, name)
        _close(a.numpy(), ja, 1e-5)
        _close(d.numpy(), jd, 1e-5)
        _close(wavelet.synthesis_step(a, d, name).numpy(), jsyn, 1e-5)
        _close(wavelet.synthesis_step_reference(a, d, name).numpy(), jsyn_ref, 1e-5)
        cur = a


def test_idwt_dwt_round_trip():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 2048)).astype(np.float32)
    coeffs = wavelet.dwt(_t(x), 5)
    jcoeffs = jax.jit(lambda v: jwavelet.dwt(v, 5))(jnp.asarray(x))
    for c, jc in zip(coeffs, jcoeffs):
        _close(c.numpy(), jc, 1e-5)
    _close(wavelet.idwt(coeffs).numpy(), x, 1e-5)


def test_wpd_matches():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 512)).astype(np.float32)
    got = wavelet.wpd(_t(x), 4)
    want = jwavelet.wpd(jnp.asarray(x), 4)
    assert got.shape == (2, 3, 16, 32)
    _close(got.numpy(), want, 1e-5)


def test_wpd_and_dwt_take_whole_trees_from_k2():
    """wavelet.wpd and wavelet.dwt hand a whole tree to K2's one-launch
    entries; on a CPU tensor those are the chained single level, so the
    numbers are analysis_step's, level by level, to the bit, and each DWT
    scale is its own contiguous tensor."""
    rng = np.random.default_rng(9)
    x = _t(rng.normal(size=(3, 128)))
    nodes = x[:, None, :]
    for _ in range(3):
        a, d = wavelet.analysis_step(nodes)
        nodes = torch.stack([a, d], dim=-2).reshape(3, -1, a.shape[-1])
    assert torch.equal(wavelet.wpd(x, 3), nodes)
    cur, want = x, []
    for _ in range(4):
        cur, d = wavelet.analysis_step(cur)
        want.append(d)
    got = wavelet.dwt(x, 4)
    assert len(got) == 5
    for c, w in zip(got, want + [cur]):
        assert c.is_contiguous() and torch.equal(c, w)


# ---------------------------------------------------------------------------
# PCA (compared by reconstruction)
# ---------------------------------------------------------------------------

def _correlated(rng, n, f):
    mix = rng.normal(size=(f, f)) * (0.7 ** np.arange(f))[:, None]
    return (rng.normal(size=(n, f)) @ mix + 3.0).astype(np.float32)


@functools.partial(jax.jit, static_argnums=1)
def _jax_pca(x, keep):
    st, stT = jpca.fit(x), jpca.fit_T(x.T)
    return (st.variances, jpca.reconstruct(st, x, keep),
            jpca.reconstruct_T(stT, x.T, keep),
            jpca.reconstruct_T(stT, x.T, jnp.asarray(keep)), jpca.kaiser_rule(st))


@pytest.mark.parametrize("keep", [1, 4, 12])
def test_pca_fit_and_reconstruct(keep):
    rng = np.random.default_rng(keep)
    x = _correlated(rng, 50, 12)
    lam, rec, recT, recT_masked, kaiser = _jax_pca(jnp.asarray(x), keep)
    st = pca.fit(_t(x))
    np.testing.assert_allclose(st.variances.numpy(), lam, atol=1e-4 * float(lam.max()))
    _close(pca.reconstruct(st, _t(x), keep).numpy(), rec, 1e-4)
    # Variable-major twin, and the masked (tensor-count) form.
    stT = pca.fit_T(_t(x.T))
    _close(pca.reconstruct_T(stT, _t(x.T), keep).numpy(), recT, 1e-4)
    _close(pca.reconstruct_T(stT, _t(x.T), torch.tensor(keep)).numpy(), recT_masked, 1e-4)
    assert int(pca.kaiser_rule(st)) == int(kaiser)


def test_pca_sign_convention():
    """The largest-|.| entry of every component is positive."""
    rng = np.random.default_rng(9)
    comps = pca.fit(_t(_correlated(rng, 40, 8))).components.numpy()
    pivots = comps[np.abs(comps).argmax(0), np.arange(8)]
    assert (pivots > 0).all()


# ---------------------------------------------------------------------------
# MSPCA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("halo_windows", [None, 2])
def test_denoise_windows_full_width(chunk, halo_windows):
    halo = None
    if halo_windows:
        halo = np.random.default_rng(1).normal(
            scale=10.0, size=(halo_windows, 3, 2048)
        ).astype(np.float32)
    want = np.asarray(jmspca.denoise_windows(
        jnp.asarray(chunk), halo=None if halo is None else jnp.asarray(halo)
    ))
    got = mspca.denoise_windows(_t(chunk), halo=None if halo is None else _t(halo)).numpy()
    assert got.shape == chunk.shape
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def test_denoise_bakshi_variant_matches():
    """Kaiser rule + universal hard threshold + final PCA. The threshold
    needs the median of |D1|: jnp.median averages the two middle values."""
    rng = np.random.default_rng(12)
    x = (np.cumsum(rng.normal(size=(256, 12)), axis=0)
         + rng.normal(scale=0.5, size=(256, 12))).astype(np.float32)
    kw = dict(level=3, threshold=True, keep="kaiser", final_pca=True)
    want = np.asarray(jmspca.denoise(jnp.asarray(x), **kw))
    got = mspca.denoise(_t(x), **kw).numpy()
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def test_snr_db_matches():
    rng = np.random.default_rng(13)
    a = rng.normal(size=(8, 3, 64)).astype(np.float32)
    b = a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
    np.testing.assert_allclose(float(mspca.snr_db(_t(a), _t(b))),
                               float(jmspca.snr_db(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    assert float(mspca.snr_db(_t(np.zeros(4)), _t(np.zeros(4)))) == 0.0


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

def test_wpd_features_full_width_in_z_units(chunk):
    got = features.wpd_features(_t(chunk))
    want = np.asarray(jfeatures.wpd_features(jnp.asarray(chunk)))
    assert got.shape == (60, features.feature_dim(3)) == want.shape
    assert _z_err(got.numpy(), want) <= 2e-3


def test_normalize_uses_population_std():
    rng = np.random.default_rng(14)
    f = rng.normal(size=(20, 6)).astype(np.float32) * 3.0
    got = features.normalize(_t(f))
    want = jfeatures.normalize(jnp.asarray(f))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# frontend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [7, 25, 30, 59])
def test_wrap_pad_tiles_cyclically(w):
    x = np.arange(w * 2 * 4, dtype=np.float32).reshape(w, 2, 4)
    got = frontend._wrap_pad(_t(x), 60).numpy()
    np.testing.assert_array_equal(got, np.resize(x, (60, 2, 4)))
    np.testing.assert_array_equal(got, np.asarray(jnp.resize(jnp.asarray(x), (60, 2, 4))))


@pytest.mark.parametrize("overlap", [0, 2])
def test_chunk_features_wrap_pad_at_30_windows(small_stream, overlap):
    cfg, jcfg = CFG._replace(overlap=overlap), JCFG._replace(overlap=overlap)
    ch = small_stream[:30]
    halo = small_stream[30:30 + overlap] if overlap else None
    want = np.asarray(jfrontend.chunk_features(
        jnp.asarray(ch), jcfg, halo=None if halo is None else jnp.asarray(halo)
    ))
    got = frontend.chunk_features(_t(ch), cfg, halo=None if halo is None else _t(halo))
    assert got.shape == want.shape == (30, 288)
    assert _z_err(got.numpy(), want) <= 2e-3


def test_reference_kernels_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        frontend.chunk_features(torch.zeros(60, 3, 512), CFG._replace(reference_kernels=True))


@pytest.mark.parametrize("overlap", [0, 2])
def test_megabatch_step_matches_jax_and_serial(small_stream, overlap):
    cfg, jcfg = CFG._replace(overlap=overlap), JCFG._replace(overlap=overlap)
    b, d, n = 2, 2, small_stream.shape[-1]
    chunks = small_stream[:240].reshape(b, d, 60, 3, n)
    active = np.array([[1, 1], [1, 0]], np.int32)
    bw = frontend.boundary_width(overlap)
    boundary = small_stream[240:240 + b * bw].reshape(b, bw, 3, n)
    phase = np.array([3, 0], np.int32)

    jstate = jfrontend.FrontendState(jnp.asarray(boundary), jnp.asarray(phase))
    jst, jfeats = jfrontend.megabatch_step(jstate, jnp.asarray(chunks), jnp.asarray(active), jcfg)
    state = frontend.FrontendState(_t(boundary), torch.from_numpy(phase))
    st, feats = frontend.megabatch_step(state, _t(chunks), torch.from_numpy(active), cfg)

    np.testing.assert_array_equal(st.boundary.numpy(), np.asarray(jst.boundary))
    np.testing.assert_array_equal(st.phase.numpy(), np.asarray(jst.phase))
    live = active.astype(bool)
    assert _z_err(feats.numpy()[live], np.asarray(jfeats)[live]) <= 2e-3

    # The port's serial loop of frontend_step over the same backlog.
    sst = state
    for j in range(d):
        nxt, f = frontend.frontend_step(sst, _t(chunks[:, j]), cfg)
        on = torch.from_numpy(active[:, j] > 0)
        for i in np.flatnonzero(active[:, j]):
            assert _z_err(f.numpy()[i], feats.numpy()[i, j]) <= 1e-5
        sst = frontend.FrontendState(
            torch.where(on[:, None, None, None], nxt.boundary, sst.boundary),
            torch.where(on, nxt.phase, sst.phase),
        )
    np.testing.assert_array_equal(sst.boundary.numpy(), st.boundary.numpy())
    np.testing.assert_array_equal(sst.phase.numpy(), st.phase.numpy())


# ---------------------------------------------------------------------------
# EEG generator
# ---------------------------------------------------------------------------

def test_patient_params_anchor_draws():
    for pid in (0, 1, 2, 7):
        want = [float(v) for v in jeeg.patient_params(pid % 2)]
        mix = (pid % 5) / 4.0
        got = eeg_data.patient_params(pid)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want) * (0.8 + 0.4 * mix), rtol=1e-6
        )


_BANDS = [(0.5, 4), (4, 8), (8, 13), (13, 30), (30, 128)]


def _band_power(w: np.ndarray) -> np.ndarray:
    spec = np.abs(np.fft.rfft(w, axis=-1)) ** 2
    f = np.fft.rfftfreq(w.shape[-1], 1.0 / eeg_data.FS)
    return np.array([spec[..., (f >= lo) & (f < hi)].sum(-1).mean() for lo, hi in _BANDS])


@pytest.mark.parametrize("state", [eeg_data.INTERICTAL, eeg_data.PREICTAL, eeg_data.ICTAL])
def test_generator_band_power_matches_reference(state):
    pid, draws, per_draw = 3, 32, 4
    want = np.concatenate([
        np.asarray(jeeg.generate_windows(jax.random.PRNGKey(s), jnp.asarray(pid), state, per_draw))
        for s in range(draws)
    ])
    gen = torch.Generator().manual_seed(0)
    got = torch.cat([
        eeg_data.generate_windows(gen, pid, state, per_draw) for _ in range(draws)
    ]).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    ratio = _band_power(got) / _band_power(want)
    assert np.all(np.abs(ratio - 1.0) <= 0.12), ratio
