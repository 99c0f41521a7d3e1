"""Rotation Forest (Rodriguez, Kuncheva & Alonso 2006) in PyTorch: the twin
of ``repro.core.rotation_forest``.

For every tree the feature set is permuted and cut into K subsets, a PCA
is fit on each subset over a bootstrap subsample with ALL components
kept, the K bases are assembled into a block-diagonal (F, F) rotation in
permuted space and un-permuted, and the tree is grown on ``x @ R``.

Each random step is split into draws and arithmetic: ``draw_trees`` takes
every random number a forest fit needs from one ``torch.Generator`` (the
feature permutations, the K block bootstrap masks and the tree bootstrap
mask of each tree), and the functions that compute take those draws as
tensors. The tests feed the same numpy-made draws to both packages.
The reference's per-tree ``vmap`` is written out as a leading tree axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import decision_tree as dt
from repro_torch.kernels.forest import ops as forest_ops


class RotationForestConfig(NamedTuple):
    """The reference's config, same fields and defaults.

    ``use_hist_kernel`` is kept because a program's ``cfg_json`` carries
    it; in the port it selects nothing. The grower's histogram always goes
    through ``kernels.histogram.ops.level_histogram`` (K4's level mode on
    a CUDA tensor, the plain scatter on a CPU tensor), and every form of
    that histogram is exact here: ``w`` is a 0/1 bootstrap mask, so each
    entry is an integer below 2**24, and K4's level and class modes, the
    port's plain scatters and both of the reference's forms (its scatter
    and its Pallas kernel, ``use_hist_kernel``) agree bit for bit whatever
    their summation order (``tests/test_torch_kernels.py`` and
    ``tests/test_torch_training.py`` pin it on the CPU, ``chip_smoke.py``
    on the card)."""

    n_trees: int = 10
    n_subsets: int = 3          # K in the paper
    depth: int = 6
    n_classes: int = 2
    n_bins: int = 32
    bootstrap_frac: float = 0.75
    min_samples: int = 2
    use_hist_kernel: bool = False


class RotationForestParams(NamedTuple):
    """Batched (leading axis = tree) parameters."""

    rotation: torch.Tensor   # (T, F, F)
    trees: dt.TreeParams     # every field with a leading T axis


class TreeDraws(NamedTuple):
    """The random numbers of a T-tree fit on N rows of F features."""

    perm: torch.Tensor         # (T, F) int64 feature permutation per tree
    block_masks: torch.Tensor  # (T, K, N) float32 0/1 bootstrap per PCA block
    tree_mask: torch.Tensor    # (T, N) float32 0/1 bootstrap of the rows


def draw_trees(
    generator: torch.Generator, n_trees: int, n: int, f: int, cfg: RotationForestConfig
) -> TreeDraws:
    """Every draw of a forest fit, on the generator's device. A mask keeps
    a row where its uniform draw is below ``cfg.bootstrap_frac``."""
    dev = generator.device
    perm = torch.argsort(torch.rand((n_trees, f), generator=generator, device=dev), dim=1)
    block = torch.rand((n_trees, cfg.n_subsets, n), generator=generator, device=dev)
    tree = torch.rand((n_trees, n), generator=generator, device=dev)
    frac = cfg.bootstrap_frac
    return TreeDraws(perm, (block < frac).to(torch.float32), (tree < frac).to(torch.float32))


def _block_components(cov: torch.Tensor) -> torch.Tensor:
    """(..., M, M) covariances -> (..., M, M) eigenvectors as columns,
    eigenvalues descending (the reference's ``argsort(-evals)``)."""
    evals, evecs = torch.linalg.eigh(cov)
    order = torch.argsort(-evals, dim=-1, stable=True)
    return torch.gather(evecs, -1, order[..., None, :].expand_as(evecs))


def _build_rotation(
    x: torch.Tensor, perm: torch.Tensor, block_masks: torch.Tensor, cfg: RotationForestConfig
) -> torch.Tensor:
    """x (N, F), perm (T, F), block_masks (T, K, N) -> (T, F, F) rotations.

    Per tree: permute the features, cut them into K contiguous blocks of
    M = F / K, fit a PCA per block on its masked rows (masked mean, then
    the covariance ``xc^T xc / (wsum - 1)``, a plain matmul as in the
    reference), keep every component, and un-permute the block-diagonal
    matrix. All T * K eigendecompositions are one batched ``eigh``.
    """
    n, f = x.shape
    t, k = block_masks.shape[:2]
    m = f // k
    blocks = x[:, perm].permute(1, 0, 2).reshape(t, n, k, m).transpose(1, 2)  # (T, K, N, M)
    mask = block_masks[..., None]
    wsum = torch.clamp(block_masks.sum(-1), min=2.0)[..., None]  # (T, K, 1)
    mean = (blocks * mask).sum(2) / wsum                          # (T, K, M)
    xc = (blocks - mean[:, :, None]) * mask
    cov = torch.matmul(xc.transpose(-1, -2), xc) / (wsum[..., None] - 1.0)
    comps = _block_components(cov)                                # (T, K, M, M)

    rot_p = torch.zeros((t, f, f), dtype=torch.float32, device=x.device)
    for i in range(k):
        rot_p[:, i * m : (i + 1) * m, i * m : (i + 1) * m] = comps[:, i]
    inv = torch.argsort(perm, dim=1)
    trees = torch.arange(t, device=x.device)[:, None, None]
    return rot_p[trees, inv[:, :, None], inv[:, None, :]]


def _prepare_trees(
    x: torch.Tensor, draws: TreeDraws, cfg: RotationForestConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every tree's data prep (the reference's ``_prepare_one`` over all
    trees): rotation (T, F, F), rotated bin codes (T, N, F), bootstrap
    weights (T, N) and bin edges (T, F, n_bins - 1)."""
    rot = _build_rotation(x, draws.perm, draws.block_masks, cfg)
    xr = torch.matmul(x, rot)
    edges = dt.compute_bin_edges(xr, cfg.n_bins)
    return rot, dt.bin_features(xr, edges), draws.tree_mask, edges


def _pad_features(x: torch.Tensor, n_subsets: int) -> torch.Tensor:
    if x.shape[1] % n_subsets != 0:
        x = F.pad(x, (0, n_subsets - x.shape[1] % n_subsets))
    return x


def fit_draws(
    x: torch.Tensor, y: torch.Tensor, draws: TreeDraws, cfg: RotationForestConfig
) -> RotationForestParams:
    """The arithmetic of ``fit`` on given draws (features already padded
    to a multiple of ``cfg.n_subsets``): prepare every tree, then ONE
    ``dt.fit_forest_binned`` grows the whole forest."""
    rots, xbs, ws, edges = _prepare_trees(x, draws, cfg)
    trees = dt.fit_forest_binned(
        xbs, y, ws, depth=cfg.depth, n_classes=cfg.n_classes, n_bins=cfg.n_bins,
        min_samples=cfg.min_samples, bin_edges=edges,
    )
    return RotationForestParams(rotation=rots, trees=trees)


def fit(
    generator: torch.Generator, x: torch.Tensor, y: torch.Tensor, cfg: RotationForestConfig
) -> RotationForestParams:
    """Fit ``cfg.n_trees`` rotation trees with the fused grower.

    x : (N, F) float features on the generator's device (zero-padded here
        to a multiple of ``cfg.n_subsets``).
    y : (N,) integer labels in [0, n_classes).
    """
    x = _pad_features(x.to(torch.float32), cfg.n_subsets)
    draws = draw_trees(generator, cfg.n_trees, x.shape[0], x.shape[1], cfg)
    return fit_draws(x, y, draws, cfg)


def fit_per_tree(
    generator: torch.Generator, x: torch.Tensor, y: torch.Tensor, cfg: RotationForestConfig
) -> RotationForestParams:
    """The per-tree oracle: the same draws as ``fit`` from the same
    generator state, but every tree grown alone by ``dt.fit_binned`` (its
    own plain-scatter histograms). Equal to ``fit``."""
    x = _pad_features(x.to(torch.float32), cfg.n_subsets)
    draws = draw_trees(generator, cfg.n_trees, x.shape[0], x.shape[1], cfg)
    rots, xbs, ws, edges = _prepare_trees(x, draws, cfg)
    trees = [
        dt.fit_binned(
            xbs[i], y, ws[i], depth=cfg.depth, n_classes=cfg.n_classes,
            n_bins=cfg.n_bins, min_samples=cfg.min_samples, bin_edges=edges[i],
        )
        for i in range(cfg.n_trees)
    ]
    return RotationForestParams(
        rotation=rots, trees=dt.TreeParams(*(torch.stack(v) for v in zip(*trees)))
    )


def pack(params: RotationForestParams) -> forest_ops.PackedForest:
    """The dense inference-only packing (K1's operands). Not cached: the
    serving path packs once into a ``ScoringProgram``."""
    return forest_ops.pack_forest(params)


def predict_proba(
    params: RotationForestParams,
    x: torch.Tensor,
    *,
    packed: forest_ops.PackedForest | None = None,
) -> torch.Tensor:
    """(N, C) ensemble-mean class probabilities through the packed forest
    (K1 on a CUDA tensor). Pass ``packed`` to skip packing."""
    if packed is None:
        packed = pack(params)
    return forest_ops.forest_predict_proba(packed, x.to(torch.float32))


def predict_proba_per_tree(params: RotationForestParams, x: torch.Tensor) -> torch.Tensor:
    """The per-tree oracle of ``predict_proba``: rotate, bin and walk each
    tree in turn, then average."""
    x = x.to(torch.float32)
    f = params.rotation.shape[-1]
    if x.shape[1] < f:
        x = F.pad(x, (0, f - x.shape[1]))
    probs = [
        dt.predict_proba(dt.TreeParams(*(v[i] for v in params.trees)), x @ params.rotation[i])
        for i in range(params.rotation.shape[0])
    ]
    return torch.stack(probs).mean(dim=0)


def predict(params: RotationForestParams, x: torch.Tensor) -> torch.Tensor:
    return torch.argmax(predict_proba(params, x), dim=-1)


def accuracy(params: RotationForestParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (predict(params, x) == y).to(torch.float32).mean()


def merge(a: RotationForestParams, b: RotationForestParams) -> RotationForestParams:
    """Union of two forests (the MapReduce reduce of training)."""
    return RotationForestParams(
        rotation=torch.cat([a.rotation, b.rotation]),
        trees=dt.TreeParams(*(torch.cat([u, v]) for u, v in zip(a.trees, b.trees))),
    )
