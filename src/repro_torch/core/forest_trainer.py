"""Rotation-forest training MapReduce-style (the paper's TRAIN phase):
the twin of ``repro.core.forest_trainer`` with the shards emulated on one
device.

  map    : each row shard extracts its features (``feature_fn``) and
           trains a sub-forest;
  reduce : the ensemble is the UNION of the sub-forests
           (``mapreduce.reduce_concat``).

Feature z-scoring uses GLOBAL moments (``global_moments``, two passes
over the shards) so every shard's trees see one feature scale and the
union is servable as it is.

RNG: the reference folds the shard index into the caller's key
(``fold_in(key, shard)``). Here one 62-bit base seed is drawn from the
caller's generator, and shard s fits with a fresh generator on the same
device seeded ``base + s``: reproducible from the caller's generator
state and distinct per shard. The streams differ from the reference's, so port-trained and
JAX-trained trees are compared by accuracy, never tree by tree.

The mesh mode (``mesh=``, one process per card over ``torch.distributed``)
is not ported yet (ROADMAP.md, queue 1 item 11).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import mapreduce as mr
from repro_torch.core import rotation_forest as rf


class DistributedFitResult(NamedTuple):
    """forest: the union of the per-shard sub-forests (leading axis =
    tree); feat_mean / feat_std: (F,) global feature moments."""

    forest: rf.RotationForestParams
    feat_mean: torch.Tensor
    feat_std: torch.Tensor


def global_moments(shard_feats: list[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard (n_s, F) features -> global (mean, std).

    Two passes, as the reference: reduce the shards' sums to the mean
    first, then the centred squares. The one-pass ``E[x^2] - mean^2``
    cancels catastrophically in float32 for the high-mean WPD power
    features. Population std plus the 1e-6 floor, as
    ``signal.features.normalize``.
    """
    count = float(sum(f.shape[0] for f in shard_feats))
    mean = mr.reduce_sum([f.sum(dim=0) for f in shard_feats]) / count
    centered_sq = mr.reduce_sum([((f - mean) ** 2).sum(dim=0) for f in shard_feats])
    return mean, torch.sqrt(centered_sq / count) + 1e-6


def _shard_trees(n_trees: int, n_shards: int) -> int:
    return max(1, -(-n_trees // n_shards))


def shard_generators(generator: torch.Generator, n_shards: int) -> list[torch.Generator]:
    """One generator per shard, on the caller's generator's device, seeded
    from one base draw of the caller's generator plus the shard index."""
    dev = generator.device
    base = int(torch.randint(2**62, (1,), generator=generator, device=dev))
    return [torch.Generator(device=dev).manual_seed(base + s) for s in range(n_shards)]


def fit_mapreduce(
    generator: torch.Generator,
    x: torch.Tensor,
    y: torch.Tensor,
    cfg: rf.RotationForestConfig,
    *,
    mesh=None,
    n_shards: int | None = None,
    trees_per_shard: int | None = None,
    feature_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> DistributedFitResult:
    """Train a rotation forest MapReduce-style over ``n_shards`` equal row
    shards of (x, y), emulated one after the other on x's device.

    x : (N, ...) training rows; with ``feature_fn`` they may be RAW data
        (EEG windows) whose features each shard extracts itself. When
        ``feature_fn`` carries cross-row context (per-chunk MSPCA), align
        the shard boundaries with it.
    y : (N,) integer labels.

    Each shard trains ``trees_per_shard`` trees (default
    ``ceil(cfg.n_trees / n_shards)``) on its rows normalized with the
    global moments; the result holds their union in shard order.
    """
    if mesh is not None:
        raise NotImplementedError(
            "fit_mapreduce(mesh=...) is not ported yet (ROADMAP.md, queue 1 "
            "item 11: the torch.distributed mode); use n_shards="
        )
    if n_shards is None:
        raise ValueError("pass n_shards=")
    shards = int(n_shards)
    if x.shape[0] % shards != 0:
        raise ValueError(
            f"{x.shape[0]} training rows do not shard evenly over {shards} "
            "shards; pad or trim to a multiple (rows are sharded on the "
            "leading axis)"
        )
    if trees_per_shard is not None and trees_per_shard < 1:
        raise ValueError(f"trees_per_shard={trees_per_shard} must be >= 1")
    shard_cfg = cfg._replace(
        n_trees=trees_per_shard if trees_per_shard is not None
        else _shard_trees(cfg.n_trees, shards)
    )
    extract = feature_fn if feature_fn is not None else (lambda x_s: x_s)
    parts = mr.MapReduce(
        lambda x_s, y_s: (extract(x_s).to(torch.float32), y_s), list
    ).run_local(shards, x, y)
    mean, std = global_moments([f for f, _ in parts])
    subs = [
        rf.fit(gen, (f - mean) / std, y_s, shard_cfg)
        for gen, (f, y_s) in zip(shard_generators(generator, shards), parts)
    ]
    return DistributedFitResult(forest=mr.reduce_concat(subs), feat_mean=mean, feat_std=std)
