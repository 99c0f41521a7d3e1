"""WPD terminal-node statistics (paper Sec. 2.2 / 2.6) in PyTorch: the
twin of ``repro.signal.features``."""

from __future__ import annotations

import torch

from repro_torch.signal import wavelet

FEATURES_PER_NODE = 6


def node_features(coeffs: torch.Tensor) -> torch.Tensor:
    """coeffs (..., M) -> (..., 6): [mean|c|, power, std, skew, kurt,
    entropy], moments with ddof 0 as in the reference."""
    eps = 1e-8
    mean_abs = coeffs.abs().mean(-1)
    sq = coeffs**2
    power = sq.mean(-1)
    cc = coeffs - coeffs.mean(-1, keepdim=True)
    var = (cc**2).mean(-1)
    std = torch.sqrt(var + eps)
    skew = (cc**3).mean(-1) / (std**3 + eps)
    kurt = (cc**4).mean(-1) / (var**2 + eps)
    p = sq / (sq.sum(-1, keepdim=True) + eps)
    entropy = -(p * torch.log(p + eps)).sum(-1)
    return torch.stack([mean_abs, power, std, skew, kurt, entropy], dim=-1)


def wpd_features(
    windows: torch.Tensor, level: int = 4, wavelet_name: str = "db4"
) -> torch.Tensor:
    """Windows (..., C, N) -> features (..., C * 2**level * 6): WPD to
    ``level`` and six statistics per terminal node, flattened over
    channels and nodes."""
    feats = node_features(wavelet.wpd(windows, level, wavelet_name))
    return feats.reshape(windows.shape[:-2] + (-1,))


def feature_dim(n_channels: int, level: int = 4) -> int:
    return n_channels * (2**level) * FEATURES_PER_NODE


def normalize(
    feats: torch.Tensor,
    mean: torch.Tensor | None = None,
    std: torch.Tensor | None = None,
):
    """Z-score (N, F) features; returns (normed, mean, std). Statistics
    computed here use ddof 0 (``jnp.std``'s default, not torch's)."""
    if mean is None:
        mean = feats.mean(dim=0)
        std = feats.std(dim=0, correction=0) + 1e-6
    return (feats - mean) / std, mean, std
