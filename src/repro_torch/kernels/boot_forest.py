"""Vectorized extra-tree ensemble of the bootstrap CP measure (paper
Section 6), counterpart of ``repro/kernels/boot_forest.py`` in plain
PyTorch on the caller's device.

The ensemble is three stacked ``(S, n_nodes)`` tensors (split feature, -1
for a leaf; threshold; majority label) over one shared row matrix, each
tree's training set a vector of integer multiplicities (a bootstrap sample
of ``X`` is a count vector). Randomness is pre-drawn by the caller, so a
fit is a pure function of ``(X, y, W, feat_choice, thr_u)``; its per-tree
semantics of record are ``ref.boot_fit_tree`` / ``ref.boot_predict_tree``,
which it equals bit for bit.

Where the reference visits the ``2^(depth+1) - 1`` nodes one at a time,
the fit here makes one pass per tree *level* (``depth + 1`` passes): every
node of a level takes its weighted label counts by one ``scatter_add`` of
the int32 weights into ``(S, nodes, L)``, and its range over the chosen
feature by one ``scatter_reduce`` ``amin`` / ``amax``. Both are exact
whatever the order (integer sums, min and max). A row that stopped at a
node that did not split keeps that node's id and matches no later level,
as in the node loop.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import first_argmax


def n_nodes(depth: int) -> int:
    """Breadth-first node count of a depth-``depth`` complete binary tree."""
    return 2 ** (depth + 1) - 1


def fit_forest(X, y, W, feat_choice, thr_u, *, n_labels: int, depth: int):
    """Fit ``S`` weighted extra-trees over shared rows.

    ``X (m, p)`` f32, ``y (m,)`` labels in ``[0, n_labels)``, ``W (S, m)``
    int32 multiplicities, ``feat_choice (S, n_nodes)`` int32 and ``thr_u
    (S, n_nodes)`` f32 pre-drawn per node, all on one device. Returns
    ``(feat, thresh, leaf)``, each ``(S, n_nodes)`` (int32, f32, int32).
    A node's leaf is the first maximum of its weighted label counts; an
    internal node splits iff its weighted count is above 1 and ``hi >
    lo``, at ``t = lo + u * (hi - lo)`` in three f32 roundings (separate
    operations, never fused), else it stores feature -1 and threshold 0.
    """
    S, m = W.shape
    dev = X.device
    nn = n_nodes(depth)
    Xt = X.t().contiguous()  # (p, m): each row's chosen value by a gather
    yl = y.long()
    drawn = W > 0
    node_of = torch.zeros((S, m), dtype=torch.int64, device=dev)
    feat = torch.full((S, nn), -1, dtype=torch.int32, device=dev)
    thresh = torch.zeros((S, nn), dtype=torch.float32, device=dev)
    leaf = torch.zeros((S, nn), dtype=torch.int32, device=dev)
    for lvl in range(depth + 1):
        base, width = 2 ** lvl - 1, 2 ** lvl
        loc = node_of - base
        here = drawn & (loc >= 0) & (loc < width)
        loc = loc.clamp(0, width - 1)
        cnt = torch.zeros((S, width * n_labels), dtype=W.dtype, device=dev)
        cnt.scatter_add_(1, loc * n_labels + yl, torch.where(here, W, 0))
        cnt = cnt.view(S, width, n_labels)
        leaf[:, base:base + width] = first_argmax(cnt)
        if lvl == depth:
            break
        fc = feat_choice[:, base:base + width]
        col = Xt.gather(0, fc.gather(1, loc).long())  # (S, m)
        inf = torch.full((S, width), float("inf"), device=dev)
        lo = inf.scatter_reduce(1, loc, torch.where(here, col, inf[:, :1]),
                                "amin")
        hi = (-inf).scatter_reduce(1, loc,
                                   torch.where(here, col, -inf[:, :1]),
                                   "amax")
        split = (cnt.sum(-1) > 1) & (hi > lo)
        diff = hi - lo
        t = lo + thr_u[:, base:base + width] * diff  # NaN where empty
        feat[:, base:base + width] = torch.where(split, fc, -1)
        thresh[:, base:base + width] = torch.where(split, t, 0.0)
        go = here & split.gather(1, loc)
        right = (col > t.gather(1, loc)).long()
        node_of = torch.where(go, 2 * node_of + 1 + right, node_of)
    return feat, thresh, leaf


def forest_predict(feat, thresh, leaf, Xq):
    """Predicted labels ``(S, q)`` int32 of ``S`` stacked trees on the
    query rows ``Xq (q, p)``: one pass per level; a row stays at a node
    that does not split."""
    S, nn = feat.shape
    depth = (nn + 1).bit_length() - 2
    Xt = Xq.t().contiguous()  # (p, q)
    node = torch.zeros((S, Xq.shape[0]), dtype=torch.int64,
                       device=Xq.device)
    for _ in range(depth):
        f = feat.gather(1, node)
        xv = Xt.gather(0, f.clamp(min=0).long())
        right = (xv > thresh.gather(1, node)).long()
        node = torch.where(f >= 0, 2 * node + 1 + right, node)
    return leaf.gather(1, node)


__all__ = ["n_nodes", "fit_forest", "forest_predict"]
