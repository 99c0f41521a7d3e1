"""Rotation-forest training MapReduce-style (the paper's TRAIN phase):
the twin of ``repro.core.forest_trainer``.

  map    : each row shard extracts its features (``feature_fn``) and
           trains a sub-forest;
  reduce : the ensemble is the UNION of the sub-forests
           (``mapreduce.reduce_concat``).

Feature z-scoring uses GLOBAL moments (``global_moments``, two passes
over the shards) so every shard's trees see one feature scale and the
union is servable as it is.

Two modes, one body (``core.mapreduce``): ``fit_mapreduce(mesh=)`` runs
one process per shard over ``torch.distributed`` (each pass of the
moments and the union all-gathered from every rank and folded in rank
order), ``fit_mapreduce(n_shards=)`` emulates the shards one after the
other in one process. A mesh of S ranks returns what ``n_shards=S``
returns on the same device type, bit for bit.

RNG: the reference folds the shard index into the caller's key
(``fold_in(key, shard)``). Here one 62-bit base seed is drawn from the
caller's generator, and shard s fits with a fresh generator on the same
device seeded ``base + s`` (``shard_generators``): reproducible from the
caller's generator state and distinct per shard; on a mesh every rank
draws the same base from its copy of the caller's state. The streams
differ from the reference's, so port-trained and JAX-trained trees are
compared by accuracy, never tree by tree.
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


def global_moments(
    feats, *, mesh=None, axis_name: str = "data"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard (n_s, F) features -> global (mean, std).

    ``feats`` is the list of every shard's features (the emulation) or,
    with ``mesh``, this rank's (n, F) features (every rank gets the same
    moments). Two passes, as the reference: the shards' row counts and
    sums first, reduced to the mean, then the centred squares; each pass
    gathered from every shard and folded in shard order. The one-pass
    ``E[x^2] - mean^2`` cancels catastrophically in float32 for the
    high-mean WPD power features. Population std plus the 1e-6 floor, as
    ``signal.features.normalize``.
    """
    if mesh is None:
        return _moments(list(feats), mr.local_shards(len(feats)))
    return _moments([feats], mr.mesh_shards(mesh, axis_name))


def _moments(held: list[torch.Tensor], shards: mr.Shards) -> tuple[torch.Tensor, torch.Tensor]:
    """``global_moments`` of the held shards' features."""
    first = shards.gather([
        (torch.tensor(f.shape[0], dtype=torch.int64, device=f.device), f.sum(dim=0))
        for f in held
    ])
    count = float(sum(int(n) for n, _ in first))
    mean = mr.reduce_sum([s for _, s in first]) / count
    centered_sq = mr.reduce_sum(shards.gather([((f - mean) ** 2).sum(dim=0) for f in held]))
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
    axis_name: str = "data",
) -> DistributedFitResult:
    """Train a rotation forest MapReduce-style over equal row shards of
    (x, y).

    x : (N, ...) training rows; with ``feature_fn`` they may be RAW data
        (EEG windows) whose features each shard extracts itself. When
        ``feature_fn`` carries cross-row context (per-chunk MSPCA), align
        the shard boundaries with it.
    y : (N,) integer labels.

    Exactly one of ``mesh`` (one process per shard along the mesh's
    ``axis_name`` dimension; every rank passes the same x, y and
    generator state and gets the same result) or ``n_shards`` (the shards
    one after the other on x's device) selects the mode. Each shard
    trains ``trees_per_shard`` trees (default ``ceil(cfg.n_trees / S)``)
    on its rows normalized with the global moments; the result holds
    their union in shard order.
    """
    if (mesh is None) == (n_shards is None):
        raise ValueError("pass exactly one of mesh= or n_shards=")
    shards = (mr.mesh_shards(mesh, axis_name) if mesh is not None
              else mr.local_shards(int(n_shards)))
    if x.shape[0] % shards.count != 0:
        raise ValueError(
            f"{x.shape[0]} training rows do not shard evenly over {shards.count} "
            "shards; pad or trim to a multiple (rows are sharded on the "
            "leading axis)"
        )
    if trees_per_shard is not None and trees_per_shard < 1:
        raise ValueError(f"trees_per_shard={trees_per_shard} must be >= 1")
    shard_cfg = cfg._replace(
        n_trees=trees_per_shard if trees_per_shard is not None
        else _shard_trees(cfg.n_trees, shards.count)
    )
    extract = feature_fn if feature_fn is not None else (lambda x_s: x_s)
    parts = [
        (extract(x_s).to(torch.float32), y_s)
        for x_s, y_s in zip(shards.split(x), shards.split(y))
    ]
    mean, std = _moments([f for f, _ in parts], shards)
    gens = shard_generators(generator, shards.count)
    subs = [
        rf.fit(gens[i], (f - mean) / std, y_s, shard_cfg)
        for i, (f, y_s) in zip(shards.held, parts)
    ]
    return DistributedFitResult(
        forest=mr.reduce_concat(shards.gather(subs)), feat_mean=mean, feat_std=std
    )
