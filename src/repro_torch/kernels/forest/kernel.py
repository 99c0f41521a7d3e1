"""ctypes wrapper of K1, ``csrc/forest.cu`` (replaces the Pallas
``repro/kernels/forest/kernel.py::forest_traverse``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0
MAX_FEATURES = 512  # x lives in registers, 16 floats a lane at most
MAX_CLASSES = 8
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]


def node_major(proj: torch.Tensor) -> torch.Tensor:
    """proj (T, F, L) -> the kernel's (T, L, F) copy, in which each node's
    column is contiguous."""
    return proj.transpose(1, 2).contiguous()


def next_live(thr: torch.Tensor) -> torch.Tensor:
    """thr (T, L) -> (T, L, 2) int32: for heap node n and side b (0 left,
    1 right), the next node on the path that has a split, or the leaf l as
    L + l. A dead node (thr = +inf) routes left whatever the row, so the
    path passes through it to its left child. Entry [t, 0] (slot 0 is not a
    node) holds the first such node from the root, on both sides."""
    n_trees, n_leaves = thr.shape
    dead = torch.isposinf(thr)
    heap = torch.arange(n_leaves, device=thr.device)
    nxt = torch.stack([2 * heap, 2 * heap + 1], dim=-1)
    nxt[0] = 1
    nxt = nxt.expand(n_trees, n_leaves, 2).clone()
    for _ in range(n_leaves.bit_length() - 1):
        inner = nxt < n_leaves
        at = nxt.clamp(max=n_leaves - 1).reshape(n_trees, -1)
        skip = dead.gather(1, at).reshape(nxt.shape) & inner
        nxt = torch.where(skip, 2 * nxt, nxt)
    return nxt.to(torch.int32).contiguous()


def forest_traverse(
    x: torch.Tensor, proj_nodes: torch.Tensor, thr: torch.Tensor, next_node: torch.Tensor,
    leaf_probs: torch.Tensor,
) -> torch.Tensor:
    """x (B, F), proj_nodes (T, L, F) = ``node_major(proj)``, thr (T, L),
    leaf_probs (T, L, C): contiguous float32, and next_node (T, L, 2) =
    ``next_live(thr)`` contiguous int32, all on x's CUDA device -> (B, C)
    leaf probabilities summed over trees in ascending order. A
    ``PackedForest`` on the card carries both tables."""
    global LAUNCHES
    for name, t in (("x", x), ("proj_nodes", proj_nodes), ("thr", thr),
                    ("leaf_probs", leaf_probs), ("next_node", next_node)):
        dtype = torch.int32 if name == "next_node" else torch.float32
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"forest kernel: {name} must be contiguous {dtype} on CUDA, "
                f"got {t.dtype} on {t.device}"
            )
        if t.device != x.device:
            raise ValueError(f"forest kernel: {name} on {t.device}, x on {x.device}")
    b, f = x.shape
    n_trees, n_leaves, f_p = proj_nodes.shape
    n_classes = leaf_probs.shape[-1]
    depth = n_leaves.bit_length() - 1
    if (
        f_p != f or not 0 < f <= MAX_FEATURES or thr.shape != (n_trees, n_leaves)
        or next_node.shape != (n_trees, n_leaves, 2)
        or leaf_probs.shape != (n_trees, n_leaves, n_classes)
        or (1 << depth) != n_leaves or not 0 < n_classes <= MAX_CLASSES
    ):
        raise ValueError(
            f"forest kernel: shapes x {tuple(x.shape)}, proj_nodes {tuple(proj_nodes.shape)}, "
            f"thr {tuple(thr.shape)}, next_node {tuple(next_node.shape)}, leaf_probs "
            f"{tuple(leaf_probs.shape)} need (B, F), (T, L, F), (T, L), (T, L, 2), (T, L, C) "
            f"with L a power of 2, 0 < F <= {MAX_FEATURES}, C <= {MAX_CLASSES}"
        )
    out = torch.empty((b, n_classes), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    fn = build.function("repro_forest_traverse", _ARGTYPES)
    build.check(
        fn(x.data_ptr(), proj_nodes.data_ptr(), thr.data_ptr(), next_node.data_ptr(),
           leaf_probs.data_ptr(),
           out.data_ptr(), b, f, n_trees, n_leaves, n_classes, depth,
           x.device.index, build.stream_of(x)),
        "forest_traverse",
    )
    LAUNCHES += 1
    return out
