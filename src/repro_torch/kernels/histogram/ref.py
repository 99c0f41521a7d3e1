"""Plain PyTorch versions of K4: the grower's weighted class histogram.

    hist[t, f, b, c] = sum_n [codes[t, n, f] == b] * wy[t, n, c]

``class_histogram`` is the TPU kernel's contract: ``codes`` holds each
sample's flat (node-local * n_bins + bin) bucket id per feature,
``wy[t, n] = w[t, n] * onehot(y[n])`` its class mass, and codes outside
``[0, n_buckets)`` match no bucket. ``level_histogram`` is the grower's
level on the kernel's own inputs: feature-major (T, F, N) bin codes, the
node-local ids, the labels and the weights, the bucket id computed here.
Each is one ``scatter_add_`` into a zeroed output with a spill bucket for
what matches none, the form of the reference's ``class_histogram_scatter``.
"""

from __future__ import annotations

import torch


def _scatter(bucket: torch.Tensor, cls: torch.Tensor, mass: torch.Tensor, n_buckets: int,
             n_classes: int) -> torch.Tensor:
    """bucket (T, F, M) int64, cls and mass broadcastable to it: the sum of
    ``mass`` at each (t, f, bucket, cls), those outside the range spilled
    -> (T, F, n_buckets, n_classes) float32."""
    t, f, m = bucket.shape
    inside = (bucket >= 0) & (bucket < n_buckets) & (cls >= 0) & (cls < n_classes)
    index = torch.where(inside, bucket * n_classes + cls, n_buckets * n_classes)
    src = mass.to(torch.float32).expand(t, f, m)
    out = torch.zeros((t, f, n_buckets * n_classes + 1), dtype=torch.float32,
                      device=bucket.device)
    out.scatter_add_(2, index, src)
    return out[:, :, :-1].reshape(t, f, n_buckets, n_classes)


def class_histogram(codes: torch.Tensor, wy: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """codes (T, N, F) integer bucket ids, wy (T, N, C) float class mass
    -> (T, F, n_buckets, C) float32."""
    t, n, f = codes.shape
    c = wy.shape[-1]
    bucket = codes.to(torch.int64).transpose(1, 2)[..., None].expand(t, f, n, c)
    cls = torch.arange(c, device=codes.device)
    return _scatter(bucket.reshape(t, f, n * c), cls.repeat(n), wy.reshape(t, 1, n * c),
                    n_buckets, c)


def level_histogram(
    codes: torch.Tensor,
    local: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    *,
    nodes_at: int,
    n_bins: int,
    n_classes: int,
) -> torch.Tensor:
    """codes (T, F, N) integer bin codes (feature-major), local (T, N)
    node-local ids, y (N,) labels, w (T, N) weights -> (T, F, nodes_at *
    n_bins, C) float32: sample n adds w[t, n] at bucket local[t, n] *
    n_bins + codes[t, f, n] and class y[n]."""
    bucket = local.to(torch.int64)[:, None, :] * n_bins + codes.to(torch.int64)
    return _scatter(bucket, y.to(torch.int64), w[:, None, :], nodes_at * n_bins, n_classes)
