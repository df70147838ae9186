"""k-NN and simplified k-NN nonconformity measures (paper Sections 3, 3.1).

Counterpart of ``repro/core/measures/knn.py``, with the same two paths:

* ``scores_standard`` / ``pvalues_standard`` — naive full CP: every
  candidate recomputes all LOO scores on the augmented set, O(n^2 l m);
* ``fit`` + ``pvalues_optimized`` — the paper's incremental&decremental
  optimization: each training point's k best same-label (and, for the
  ratio measure, different-label) distances are kept, and a candidate
  updates each score in O(1) (paper Fig. 1), O(n l m) in all.

Distances come from ``kops.sq_dists`` (the pairwise kernel on the card:
fixed-order sums, so a row's bits do not depend on the batch). Missing
neighbours are ``BIG`` in both paths. Score sums over k run left to
right (``online.fsum``), in the cancellation-safe ``base + (kth or d)``
form of the reference. ``fit`` and the standard path work in row blocks,
so no ``(n, n)`` tensor is held; the blocks give the same bits as one
pass.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch._device import BIG, row_blocks
from repro_torch.core import pvalues as pv
from repro_torch.core.online import fsum
from repro_torch.kernels import ops as kops

BLOCK_ELEMS = 2**28  # elements of one (rows, n) block of distances


def _dists(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Euclidean distances ``(m, n)`` from the rows of ``A`` to ``B``."""
    d2 = kops.sq_dists(A.contiguous()[None], B.contiguous()[None])[0]
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _k_best(d: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` smallest of ``d`` where ``mask``, ascending, BIG-padded.
    Values only, so ``topk``'s tie order cannot change the result."""
    d = torch.where(mask, d, BIG)
    return torch.sort(torch.topk(d, k, largest=False, sorted=False).values,
                      dim=-1).values


def _base(best: torch.Tensor) -> torch.Tensor:
    """Sum of the ``k - 1`` best distances, left to right."""
    if best.shape[-1] == 1:
        return best.new_zeros(best.shape[:-1])
    return fsum(best[..., :-1])


def _score(kbest_same, kbest_diff, simplified: bool):
    num = fsum(kbest_same)
    return num if simplified else num / fsum(kbest_diff)


# ---------------------------------------------------------------------------
# standard (naive) path
# ---------------------------------------------------------------------------


def _standard_scores(D, ya, r0: int, k: int, simplified: bool):
    """LOO scores of the augmented rows ``r0, r0 + 1, ...`` from their
    distance rows ``D (b, n + 1)``."""
    cols = torch.arange(D.shape[1], device=D.device)
    other = cols[r0:r0 + D.shape[0], None] != cols[None, :]
    eq = ya[r0:r0 + D.shape[0], None] == ya[None, :]
    diff = None if simplified else _k_best(D, ~eq & other, k)
    return _score(_k_best(D, eq & other, k), diff, simplified)


def _augment(X, y, x_test, y_hat):
    Xa = torch.cat([X, x_test[None]])
    ya = torch.cat([y, y.new_full((1,), int(y_hat))])
    return Xa, ya


def _augmented_scores(Xa, ya, labels, k: int, simplified: bool):
    """``(len(labels), n + 1)`` LOO scores over ``Xa`` with the last label
    set to each of ``labels``, in row blocks of at most ``BLOCK_ELEMS``
    distances (the distances are label-independent)."""
    s = Xa.new_empty((len(labels), Xa.shape[0]))
    for r0, r1 in row_blocks(Xa.shape[0], Xa.shape[0], BLOCK_ELEMS):
        D = _dists(Xa[r0:r1], Xa)
        for c, lbl in enumerate(labels):
            ya[-1] = lbl
            s[c, r0:r1] = _standard_scores(D, ya, r0, k, simplified)
    return s


def scores_standard(X, y, x_test, y_hat, *, k: int, simplified: bool):
    """Naive LOO scores for one candidate: ``(alphas (n,), alpha)``."""
    Xa, ya = _augment(X, y, x_test, y_hat)
    s = _augmented_scores(Xa, ya, [int(y_hat)], k, simplified)[0]
    return s[:-1], s[-1]


def pvalues_standard(X, y, X_test, *, k: int, simplified: bool,
                     n_labels: int):
    """Naive full-CP p-values ``(m, n_labels)``."""
    out = X.new_empty((X_test.shape[0], n_labels))
    for t in range(X_test.shape[0]):
        Xa, ya = _augment(X, y, X_test[t], 0)
        s = _augmented_scores(Xa, ya, range(n_labels), k, simplified)
        out[t] = pv.pvalue(s[:, :-1], s[:, -1])
    return out


# ---------------------------------------------------------------------------
# optimized (incremental&decremental) path
# ---------------------------------------------------------------------------


@dataclass
class KnnState:
    """Each training point's k best distances to same- and different-label
    points (ascending, BIG-padded); the last column is Delta_i^k."""

    X: torch.Tensor  # (n, p)
    y: torch.Tensor  # (n,) int32
    best_same: torch.Tensor  # (n, k)
    best_diff: torch.Tensor  # (n, k)

    def leaves(self):
        return [self.X, self.y, self.best_same, self.best_diff]

    @property
    def n(self) -> int:
        return self.X.shape[0]


def fit(X, y, *, k: int) -> KnnState:
    """O(n^2) training phase in row blocks of at most ``BLOCK_ELEMS``
    distances (the block size does not change the bits)."""
    n = X.shape[0]
    best_same = X.new_empty((n, k))
    best_diff = X.new_empty((n, k))
    cols = torch.arange(n, device=X.device)
    for r0, r1 in row_blocks(n, n, BLOCK_ELEMS):
        D = _dists(X[r0:r1], X)
        other = cols[r0:r1, None] != cols[None, :]
        eq = y[r0:r1, None] == y[None, :]
        best_same[r0:r1] = _k_best(D, eq & other, k)
        best_diff[r0:r1] = _k_best(D, ~eq & other, k)
    return KnnState(X, y, best_same, best_diff)


def _updated_scores(state: KnnState, d, same, simplified: bool):
    """O(1)-per-point update (paper Fig. 1), never subtracting: ``base +
    (kth or d)``. ``d (.., n)`` and ``same (.., n)`` broadcast."""
    kth_s = state.best_same[:, -1]
    num = _base(state.best_same) + torch.where(same & (d < kth_s), d, kth_s)
    if simplified:
        return num
    kth_d = state.best_diff[:, -1]
    den = _base(state.best_diff) + torch.where(~same & (d < kth_d), d,
                                               kth_d)
    return num / den


def _candidate_score(state: KnnState, d, same, k: int, simplified: bool):
    diff = None if simplified else _k_best(d, ~same, k)
    return _score(_k_best(d, same, k), diff, simplified)


def scores_optimized(state: KnnState, x_test, y_hat, *, k: int,
                     simplified: bool):
    """``(alphas (n,), alpha)`` for one candidate."""
    d = _dists(x_test[None], state.X)[0]
    same = state.y == int(y_hat)
    return (_updated_scores(state, d, same, simplified),
            _candidate_score(state, d, same, k, simplified))


def pvalues_optimized(state: KnnState, X_test, *, k: int, simplified: bool,
                      n_labels: int):
    """Optimized full-CP p-values ``(m, n_labels)``, O(n l) per test
    point; test points go in blocks (a row's bits do not depend on it)."""
    labels = torch.arange(n_labels, dtype=state.y.dtype,
                          device=state.y.device)
    same = state.y[None, :] == labels[:, None]  # (L, n)
    out = []
    for t0, t1 in row_blocks(X_test.shape[0], n_labels * state.n,
                             BLOCK_ELEMS):
        d = _dists(X_test[t0:t1], state.X)[:, None, :]  # (b, 1, n)
        alphas = _updated_scores(state, d, same, simplified)
        alpha = _candidate_score(state, d, same, k, simplified)
        out.append(pv.pvalue(alphas, alpha))
    return torch.cat(out)


def incremental_add(state: KnnState, x_new, y_new, *, k: int) -> KnnState:
    """Learn one example in O(n k): rows the new point enters re-sort their
    lists; its own lists are the k best of its distance row. Equals ``fit``
    on the data with the point appended, bit for bit."""
    d = _dists(x_new[None], state.X)[0]
    same = state.y == int(y_new)

    def insert(best, mask):
        cand = torch.where(mask, d, BIG)
        return torch.sort(torch.cat([best, cand[:, None]], 1),
                          dim=1).values[:, :k]

    return KnnState(
        torch.cat([state.X, x_new[None]]),
        torch.cat([state.y, state.y.new_full((1,), int(y_new))]),
        torch.cat([insert(state.best_same, same),
                   _k_best(d, same, k)[None]]),
        torch.cat([insert(state.best_diff, ~same),
                   _k_best(d, ~same, k)[None]]))


def _delete(t: torch.Tensor, i: int) -> torch.Tensor:
    return torch.cat([t[:i], t[i + 1:]])


def decremental_remove(state: KnnState, i: int, *, k: int) -> KnnState:
    """Forget point ``i``: rows whose same- (or different-) label list held
    it backfill from their recomputed distance row, O(a n p) for ``a``
    affected rows. Equals ``fit`` on the remaining data, bit for bit."""
    n = state.n
    i = int(i)
    if not -n <= i < n:
        raise IndexError(f"index {i} out of range for {n} training points")
    i %= n
    d_i = _dists(state.X[i][None], state.X)[0]
    keep = torch.arange(n, device=state.X.device) != i
    yi = state.y[i]
    aff_s = (state.y == yi) & keep & (d_i <= state.best_same[:, -1])
    aff_d = (state.y != yi) & keep & (d_i <= state.best_diff[:, -1])
    rows = np.flatnonzero((aff_s | aff_d).cpu().numpy())
    best_same, best_diff = state.best_same.clone(), state.best_diff.clone()
    if rows.size:
        r = torch.as_tensor(rows, device=state.X.device)
        D = _dists(state.X[r], state.X)  # (a, n)
        other = keep[None, :] & (r[:, None] != torch.arange(
            n, device=r.device)[None, :])
        eq = state.y[r][:, None] == state.y[None, :]
        best_same[r] = torch.where(aff_s[r][:, None],
                                   _k_best(D, eq & other, k), best_same[r])
        best_diff[r] = torch.where(aff_d[r][:, None],
                                   _k_best(D, ~eq & keep[None, :], k),
                                   best_diff[r])
    return KnnState(_delete(state.X, i), _delete(state.y, i),
                    _delete(best_same, i), _delete(best_diff, i))


__all__ = ["BIG", "KnnState", "fit", "scores_standard", "pvalues_standard",
           "scores_optimized", "pvalues_optimized", "incremental_add",
           "decremental_remove"]
