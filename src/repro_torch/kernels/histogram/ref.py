"""Plain PyTorch version of K4: the grower's weighted class histogram.

    hist[t, f, b, c] = sum_n [codes[t, n, f] == b] * wy[t, n, c]

``codes`` holds each sample's flat (node-local * n_bins + bin) bucket id
per feature, ``wy[t, n] = w[t, n] * onehot(y[n])`` its class mass. Codes
outside ``[0, n_buckets)`` match no bucket. Written as one
``scatter_add_`` into a zeroed output with a spill bucket for the
out-of-range codes, the form of the reference's
``class_histogram_scatter``.
"""

from __future__ import annotations

import torch


def class_histogram(codes: torch.Tensor, wy: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """codes (T, N, F) integer bucket ids, wy (T, N, C) float class mass
    -> (T, F, n_buckets, C) float32."""
    t, n, f = codes.shape
    c = wy.shape[-1]
    inside = (codes >= 0) & (codes < n_buckets)
    safe = torch.where(inside, codes, n_buckets).to(torch.int64).transpose(1, 2)
    classes = torch.arange(c, device=codes.device)
    index = (safe[..., None] * c + classes).reshape(t, f, n * c)
    src = wy.to(torch.float32)[:, None].expand(t, f, n, c).reshape(t, f, n * c)
    out = torch.zeros((t, f, (n_buckets + 1) * c), dtype=torch.float32, device=codes.device)
    out.scatter_add_(2, index, src)
    return out.reshape(t, f, n_buckets + 1, c)[:, :, :n_buckets]
