"""Synthetic Freiburg-like EEG: the port's twin of ``repro.signal.eeg_data``.

Same acquisition geometry (256 Hz, 3 channels, 2048-sample windows, 60
windows per 8-minute matrix) and the same regime formulas. The JAX
generator draws its two anchor patients from ``jax.random``; those draws
are carried here as literals, conditioned by patient parity and ``mix``
exactly as the reference does. Noise and phases come from a
``torch.Generator``, so only the statistics match the reference, never
the bits. The recording functions draw their parts from one generator in
turn, where the reference splits its key.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

FS = 256            # Hz
N_CHANNELS = 3
WINDOW = 2048       # 8 s x 256 Hz
WINDOWS_PER_MATRIX = 60  # 8 minutes of 8-second windows

INTERICTAL, PREICTAL, ICTAL = 0, 1, 2


class PatientParams(NamedTuple):
    alpha_amp: float
    beta_amp: float
    theta_amp: float
    alpha_freq: float
    spike_freq: float
    noise: float
    ramp: float       # preictal drift rate
    synchrony: float  # ictal cross-channel coupling


# ``repro.signal.eeg_data.patient_params(0)`` and ``(1)``: the two
# anchor draws (jax.random.PRNGKey(1000 + id)) as float32 values.
_ANCHORS = (
    PatientParams(13.951170921325684, 2.144787311553955, 5.102010726928711,
                  9.039176940917969, 3.9207205772399902, 2.869429588317871,
                  1.1474241018295288, 0.7221192717552185),
    PatientParams(11.364697456359863, 2.3748416900634766, 4.430662631988525,
                  10.634982109069824, 4.261578559875488, 5.398454189300537,
                  1.3987019062042236, 0.8858803510665894),
)


def patient_params(patient_id: int) -> PatientParams:
    """Anchor draw by parity, scaled by ``0.8 + 0.4 * mix`` with
    ``mix = (id % 5) / 4`` -- the conditioning ``generate_windows`` of
    the reference applies."""
    mix = (patient_id % 5) / 4.0
    anchor = _ANCHORS[patient_id % 2]
    return PatientParams(*(v * (0.8 + 0.4 * mix) for v in anchor))


def _pink_noise(generator: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    """Approximate 1/f noise with unit std per window (ddof 0)."""
    n = shape[-1]
    white = torch.randn(shape, generator=generator, device=generator.device)
    spec = torch.fft.rfft(white, dim=-1)
    freqs = torch.fft.rfftfreq(n, d=1.0 / FS, device=white.device)
    pink = torch.fft.irfft(spec / torch.sqrt(freqs.clamp(min=1.0)), n=n, dim=-1)
    return pink / (pink.std(dim=-1, keepdim=True, correction=0) + 1e-8)


def generate_windows(
    generator: torch.Generator, patient_id: int, state: int, n_windows: int
) -> torch.Tensor:
    """(n_windows, N_CHANNELS, WINDOW) float32 EEG in microvolts, on the
    generator's device. For PREICTAL the window index within the call
    parameterizes the drift toward onset (later windows are closer)."""
    pp = patient_params(patient_id)
    dev = generator.device
    if n_windows == 0:  # draws nothing
        return torch.zeros((0, N_CHANNELS, WINDOW), dtype=torch.float32, device=dev)
    t = torch.arange(n_windows * WINDOW, dtype=torch.float32, device=dev) / FS
    t = t.reshape(n_windows, WINDOW)
    phases = torch.rand(
        (N_CHANNELS, 4), generator=generator, device=dev
    ) * (2 * math.pi)  # per channel: alpha, beta, theta, spike
    drift = (
        torch.arange(n_windows, dtype=torch.float32, device=dev)
        / max(n_windows - 1, 1)
    )[:, None]
    two_pi_t = 2 * math.pi * t

    chans = []
    for c in range(N_CHANNELS):
        ph = phases[c]
        alpha = pp.alpha_amp * torch.sin(pp.alpha_freq * two_pi_t + ph[0])
        beta = pp.beta_amp * torch.sin(21.0 * two_pi_t + ph[1])
        theta = pp.theta_amp * torch.sin(6.0 * two_pi_t + ph[2])
        noise = pp.noise * _pink_noise(generator, tuple(t.shape))
        if state == INTERICTAL:
            sig = alpha + beta + 0.3 * theta + noise
        elif state == PREICTAL:
            ramp = 1.0 + pp.ramp * drift
            carrier = torch.sin(6.0 * two_pi_t)
            sync_theta = pp.theta_amp * carrier  # common phase
            sharp = torch.sign(carrier) * carrier.abs() ** 0.3
            sig = (
                alpha * (1.0 - 0.3 * drift)
                + beta
                + ramp * (0.5 * theta + pp.synchrony * sync_theta)
                + pp.theta_amp * (0.5 + 1.2 * drift) * sharp
                + noise * (1.0 + 0.5 * drift)
            )
        else:  # ICTAL: spike-wave discharge, shared phase across channels
            carrier = torch.sin(pp.spike_freq * two_pi_t)
            spikes = torch.sign(carrier) * carrier.abs() ** 0.3
            sig = 4.0 * pp.alpha_amp * spikes + 0.5 * alpha + noise * 0.5
        chans.append(sig.to(torch.float32))
    return torch.stack(chans, dim=1)


class Recording(NamedTuple):
    """A labeled, windowed recording: the unit the pipeline consumes."""

    windows: torch.Tensor  # (W, C, WINDOW) float32
    labels: torch.Tensor   # (W,) int32, 0 = interictal, 1 = preictal/ictal


def _labels(n_zeros: int, n_ones: int, device) -> torch.Tensor:
    return torch.cat([
        torch.zeros((n_zeros,), dtype=torch.int32, device=device),
        torch.ones((n_ones,), dtype=torch.int32, device=device),
    ])


def make_training_set(
    generator: torch.Generator,
    patient_id: int,
    n_interictal_windows: int = 120,
    n_preictal_windows: int = 120,
) -> Recording:
    """Balanced training recording (Sec. 2.6): interictal windows, then
    the preictal run-up, on the generator's device."""
    inter = generate_windows(generator, patient_id, INTERICTAL, n_interictal_windows)
    pre = generate_windows(generator, patient_id, PREICTAL, n_preictal_windows)
    return Recording(
        windows=torch.cat([inter, pre]),
        labels=_labels(n_interictal_windows, n_preictal_windows, generator.device),
    )


def stratify_chunks(recording: Recording, per: int = WINDOWS_PER_MATRIX) -> Recording:
    """Reorder whole ``per``-window chunks so the classes spread evenly.

    ``make_training_set`` lays out every interictal window before every
    preictal one, so contiguous MapReduce shards of it would each hold one
    class. Each class's chunks are placed at even fractional strides
    ((i + 0.5) / k_class) and the order sorts those positions (stable), so
    chunk-aligned shards stay as mixed as the class ratio allows. Chunks
    are never split; trailing sub-chunk windows stay at the end. The order
    is computed in numpy exactly as the reference computes it.
    """
    w = recording.windows.shape[0]
    n = w // per
    if n < 2:
        return recording
    labs = recording.labels[: n * per].cpu().numpy().reshape(n, per)
    major = labs.mean(axis=1) > 0.5
    by_class = [np.where(~major)[0], np.where(major)[0]]
    idx = np.concatenate([c for c in by_class if len(c)])
    pos = np.concatenate([(np.arange(len(c)) + 0.5) / len(c) for c in by_class if len(c)])
    order = idx[np.argsort(pos, kind="stable")]
    win_idx = (order[:, None] * per + np.arange(per)[None, :]).reshape(-1)
    win_idx = np.concatenate([win_idx, np.arange(n * per, w)])
    index = torch.from_numpy(win_idx).to(recording.windows.device)
    return Recording(windows=recording.windows[index], labels=recording.labels[index])


def make_test_timeline(
    generator: torch.Generator,
    patient_id: int,
    hours_interictal: int = 2,
    minutes_preictal: int = 48,
) -> Recording:
    """A chronological test stream: hours of interictal EEG, then the
    preictal run-up and 8 windows of the seizure (the Figs. 3-10
    protocol), in temporal order on the generator's device."""
    w_inter = hours_interictal * 450  # 450 8-second windows per hour
    w_pre = minutes_preictal * 60 // 8
    windows = torch.cat([
        generate_windows(generator, patient_id, INTERICTAL, w_inter),
        generate_windows(generator, patient_id, PREICTAL, w_pre),
        generate_windows(generator, patient_id, ICTAL, 8),
    ])
    return Recording(windows=windows, labels=_labels(w_inter, w_pre + 8, generator.device))
