"""Synthetic Freiburg-like EEG: the port's twin of ``repro.signal.eeg_data``.

Same acquisition geometry (256 Hz, 3 channels, 2048-sample windows, 60
windows per 8-minute matrix) and the same regime formulas. The JAX
generator draws its two anchor patients from ``jax.random``; those draws
are carried here as literals, conditioned by patient parity and ``mix``
exactly as the reference does. Noise and phases come from a
``torch.Generator``, so only the statistics match the reference, never
the bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

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
