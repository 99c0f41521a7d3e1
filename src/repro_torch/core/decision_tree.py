"""Fixed-depth histogram decision trees in PyTorch: the twin of
``repro.core.decision_tree``, the rotation forest's base learner.

Features are quantile-binned to ``n_bins`` integer codes, and trees grow
level-synchronously: at each depth every node's best (feature, bin) split
comes from a weighted class histogram of the whole level.

  * ``fit_binned``        -- one tree, its histogram a plain scatter. The
    per-tree oracle.
  * ``fit_forest_binned`` -- all T trees at once over (T, N, F) codes: one
    (T, F, nodes * bins, C) histogram per level through the K4 kernel
    (``kernels.histogram.ops.level_histogram``, on the codes laid out
    feature-major once per fit), one argmax, one routing step. Equal to T
    ``fit_binned`` fits: the bootstrap masses are 0/1, so every histogram
    entry is an exact integer in either form, and the split choice runs
    the same ops on it.

Ties between candidate splits are common with integer counts. Both
argmaxes take the FIRST maximum over the gains flattened feature-major
within each node, as ``jnp.argmax`` does in the reference.

Heap node indexing: root = 1, children of i = (2i, 2i+1); a depth-D tree
has 2**D leaves with heap ids [2**D, 2**(D+1)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.histogram import ops as hist_ops


class TreeParams(NamedTuple):
    """A fitted tree, or with a leading T axis on every field a forest.

    split_feature : (2**depth,) int32 feature per internal heap node (entry
                    0 unused); -1 = no split (everything goes left).
    split_bin     : (2**depth,) int32; go left iff bin code <= split_bin.
    leaf_probs    : (2**depth, C) float32 class distribution per leaf.
    bin_edges     : (F, n_bins - 1) float32 quantile edges of the features.
    """

    split_feature: torch.Tensor
    split_bin: torch.Tensor
    leaf_probs: torch.Tensor
    bin_edges: torch.Tensor

    @property
    def depth(self) -> int:
        return int(self.leaf_probs.shape[-2]).bit_length() - 1


def compute_bin_edges(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(..., N, F) features -> (..., F, n_bins - 1) quantile edges per
    feature, interpolated linearly between order statistics as
    ``jnp.quantile`` does (the two round the interpolation differently,
    ~1 ulp)."""
    x = x.to(torch.float32)
    qs = torch.linspace(0.0, 1.0, n_bins + 1, device=x.device)[1:-1]
    return torch.quantile(x, qs, dim=-2, interpolation="linear").movedim(0, -1)


def bin_features(x: torch.Tensor, bin_edges: torch.Tensor) -> torch.Tensor:
    """Digitize (..., N, F) features with (..., F, E) edges into int32
    codes in [0, E]: the count of edges strictly below each value
    (``searchsorted`` side left, the reference's default)."""
    values = x.to(torch.float32).transpose(-1, -2).contiguous()
    codes = torch.searchsorted(bin_edges.contiguous(), values, side="left")
    return codes.transpose(-1, -2).to(torch.int32).contiguous()


def _gini_gain(hist_left: torch.Tensor, hist_parent: torch.Tensor) -> torch.Tensor:
    """Negative weighted child Gini impurity of a candidate split (higher
    is better). hist_left, hist_parent: (..., C) class mass going left and
    at the node."""
    hist_right = hist_parent - hist_left
    n_l = hist_left.sum(-1)
    n_r = hist_right.sum(-1)
    n = n_l + n_r

    def gini(h, cnt):
        p = h / torch.clamp(cnt[..., None], min=1e-12)
        return 1.0 - (p * p).sum(-1)

    w = (n_l * gini(hist_left, n_l) + n_r * gini(hist_right, n_r)) / torch.clamp(n, min=1e-12)
    return -w


def _choose_splits(
    hist: torch.Tensor, *, n_bins: int, min_samples: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One level's split per (tree, node) from hist (T, F, nodes, bins, C):
    returns (feature, bin), each (T, nodes) int32, with -1 / n_bins at
    nodes that do not split (too few samples, pure, or no valid split)."""
    t, f, nodes = hist.shape[:3]
    parent = hist.sum(dim=3)          # (T, F, nodes, C), equal for every f
    left_cum = hist.cumsum(dim=3)     # split at bin b => bins <= b go left
    gain = _gini_gain(left_cum, parent[:, :, :, None, :])  # (T, F, nodes, bins)
    gain[..., -1] = -torch.inf        # the degenerate everything-left split
    n_left = left_cum.sum(-1)
    n_tot = parent.sum(-1)[..., None]
    valid = (n_left > 0) & (n_tot - n_left > 0)
    gain = torch.where(valid, gain, -torch.inf)

    flat_gain = gain.transpose(1, 2).reshape(t, nodes, f * n_bins)
    best = torch.argmax(flat_gain, dim=2)  # first maximum, as jnp.argmax
    best_gain = torch.gather(flat_gain, 2, best[..., None])[..., 0]
    best_feat = (best // n_bins).to(torch.int32)
    best_bin = (best % n_bins).to(torch.int32)

    node_n = parent[:, 0].sum(-1)  # (T, nodes)
    node_gini = 1.0 - ((parent[:, 0] / torch.clamp(node_n[..., None], min=1e-12)) ** 2).sum(-1)
    do_split = (node_n >= min_samples) & torch.isfinite(best_gain) & (node_gini > 1e-9)
    best_feat = torch.where(do_split, best_feat, -1).to(torch.int32)
    best_bin = torch.where(do_split, best_bin, n_bins).to(torch.int32)
    return best_feat, best_bin


def _leaf_probs(leaf_hist: torch.Tensor) -> torch.Tensor:
    """(T, L, C) leaf class mass -> Laplace-smoothed class distributions
    (an empty leaf predicts the tree's class prior)."""
    prior = leaf_hist.sum(dim=1)
    prior = prior / torch.clamp(prior.sum(-1, keepdim=True), min=1e-12)
    leaf_n = leaf_hist.sum(-1, keepdim=True)
    return (leaf_hist + 1e-3 * prior[:, None, :]) / (leaf_n + 1e-3)


def _no_edges(lead: tuple, f: int, n_bins: int, device) -> torch.Tensor:
    return torch.zeros(lead + (f, n_bins - 1), dtype=torch.float32, device=device)


def fit_binned(
    xb: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    *,
    depth: int,
    n_classes: int,
    n_bins: int,
    min_samples: int = 2,
    bin_edges: torch.Tensor | None = None,
) -> TreeParams:
    """Fit one depth-``depth`` tree on pre-binned features.

    xb : (N, F) int32 bin codes.   y : (N,) integer labels.
    w  : (N,) float32 sample weights (0 masks a sample out: the bootstrap).
    """
    n, f = xb.shape
    dev = xb.device
    y = y.to(torch.int64)
    w = w.to(torch.float32)
    split_feature = torch.full((2**depth,), -1, dtype=torch.int32, device=dev)
    split_bin = torch.full((2**depth,), n_bins, dtype=torch.int32, device=dev)
    assignment = torch.ones((n,), dtype=torch.int64, device=dev)
    feat_ids = torch.arange(f, device=dev)
    samp_ids = torch.arange(n, device=dev)

    for level in range(depth):
        nodes_at = 2**level
        local = assignment - nodes_at
        flat_idx = local[:, None] * n_bins + xb
        hist = torch.zeros((f, nodes_at * n_bins, n_classes), dtype=torch.float32, device=dev)
        hist.index_put_(
            (feat_ids[None, :], flat_idx, y[:, None]), w[:, None].expand(n, f),
            accumulate=True,
        )
        best_feat, best_bin = _choose_splits(
            hist.reshape(1, f, nodes_at, n_bins, n_classes),
            n_bins=n_bins, min_samples=min_samples,
        )
        best_feat, best_bin = best_feat[0], best_bin[0]
        split_feature[nodes_at : 2 * nodes_at] = best_feat
        split_bin[nodes_at : 2 * nodes_at] = best_bin

        feat_at = best_feat[local]
        samp_feat = torch.where(feat_at < 0, 0, feat_at).to(torch.int64)
        go_right = xb[samp_ids, samp_feat] > best_bin[local]
        assignment = 2 * assignment + go_right.to(torch.int64)

    leaf_hist = torch.zeros((2**depth, n_classes), dtype=torch.float32, device=dev)
    leaf_hist.index_put_((assignment - 2**depth, y), w, accumulate=True)
    leaf_probs = _leaf_probs(leaf_hist[None])[0]
    if bin_edges is None:
        bin_edges = _no_edges((), f, n_bins, dev)
    return TreeParams(split_feature, split_bin, leaf_probs, bin_edges)


def fit_forest_binned(
    xb: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    *,
    depth: int,
    n_classes: int,
    n_bins: int,
    min_samples: int = 2,
    bin_edges: torch.Tensor | None = None,
) -> TreeParams:
    """Grow all T trees level-synchronously on pre-binned features.

    xb : (T, N, F) int32 bin codes (tree t sees its own rotated binning).
    y  : (N,) integer labels, shared by every tree.
    w  : (T, N) float32 per-tree sample weights.

    The codes are laid out feature-major, (T, F, N) in the narrowest type
    (uint8 up to 256 bins), once per fit. Each level's histogram over every
    tree, feature, node and bin is then ONE call of ``level_histogram`` on
    them and the level's node-local ids (K4 on a CUDA tensor, which computes
    the bucket ids itself), so a fit launches the kernel ``depth`` times.
    Returns ``TreeParams`` with a leading T axis on every field.
    """
    t, n, f = xb.shape
    dev = xb.device
    w = w.to(torch.float32).contiguous()
    y32 = y.to(torch.int32).contiguous()
    codes = hist_ops.feature_major(xb, n_bins)
    split_feature = torch.full((t, 2**depth), -1, dtype=torch.int32, device=dev)
    split_bin = torch.full((t, 2**depth), n_bins, dtype=torch.int32, device=dev)
    assignment = torch.ones((t, n), dtype=torch.int32, device=dev)

    for level in range(depth):
        nodes_at = 2**level
        local = assignment - nodes_at  # (T, N) in [0, nodes_at)
        hist = hist_ops.level_histogram(
            codes, local, y32, w, nodes_at=nodes_at, n_bins=n_bins, n_classes=n_classes
        )
        best_feat, best_bin = _choose_splits(
            hist.reshape(t, f, nodes_at, n_bins, n_classes),
            n_bins=n_bins, min_samples=min_samples,
        )
        split_feature[:, nodes_at : 2 * nodes_at] = best_feat
        split_bin[:, nodes_at : 2 * nodes_at] = best_bin

        # Route every tree's samples through its own fresh splits.
        local = local.to(torch.int64)
        feat_at = torch.gather(best_feat, 1, local)
        bin_at = torch.gather(best_bin, 1, local)
        samp_feat = torch.where(feat_at < 0, 0, feat_at).to(torch.int64)
        val = torch.gather(xb, 2, samp_feat[..., None])[..., 0]
        assignment = 2 * assignment + (val > bin_at).to(torch.int32)

    # Leaf class distributions: a plain scatter (no kernel in the reference).
    leaf_hist = torch.zeros((t, 2**depth, n_classes), dtype=torch.float32, device=dev)
    leaf_hist.index_put_(
        (torch.arange(t, device=dev)[:, None], (assignment - 2**depth).to(torch.int64),
         y.to(torch.int64)[None, :]),
        w, accumulate=True,
    )
    if bin_edges is None:
        bin_edges = _no_edges((t,), f, n_bins, dev)
    return TreeParams(split_feature, split_bin, _leaf_probs(leaf_hist), bin_edges)


def fit(
    x: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor | None = None,
    *,
    depth: int = 6,
    n_classes: int = 2,
    n_bins: int = 32,
    min_samples: int = 2,
) -> TreeParams:
    """Fit one tree on raw (N, F) float features: quantile-bin, then
    ``fit_binned``."""
    x = x.to(torch.float32)
    if w is None:
        w = torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)
    edges = compute_bin_edges(x, n_bins)
    return fit_binned(
        bin_features(x, edges), y, w, depth=depth, n_classes=n_classes,
        n_bins=n_bins, min_samples=min_samples, bin_edges=edges,
    )


def predict_proba_binned(params: TreeParams, xb: torch.Tensor) -> torch.Tensor:
    """(N, C) class probabilities of one tree from pre-binned codes."""
    n = xb.shape[0]
    rows = torch.arange(n, device=xb.device)
    node = torch.ones((n,), dtype=torch.int64, device=xb.device)
    for _ in range(params.depth):
        feat = params.split_feature[node]
        thr = params.split_bin[node]
        safe_feat = torch.where(feat < 0, 0, feat).to(torch.int64)
        go_right = (xb[rows, safe_feat] > thr) & (feat >= 0)
        node = 2 * node + go_right.to(torch.int64)
    return params.leaf_probs[node - 2**params.depth]


def predict_proba(params: TreeParams, x: torch.Tensor) -> torch.Tensor:
    return predict_proba_binned(params, bin_features(x, params.bin_edges))


def predict(params: TreeParams, x: torch.Tensor) -> torch.Tensor:
    return torch.argmax(predict_proba(params, x), dim=-1)
