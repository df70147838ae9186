"""KDE nonconformity measure (paper Section 4), standard and optimized.

Counterpart of ``repro/core/measures/kde.py``: ``A((x, y); S) = -(1 /
(n_y h^p)) sum_{x_i in S, y_i = y} K((x - x_i) / h)``, Gaussian ``K``.
The training phase keeps each point's same-label kernel sum without
itself (``prelim``, one ``kops.kde_rowsums`` launch: the hand kernel on
the card); a candidate then needs one kernel value per training point.

Every kernel sum runs left to right, one rounding per add, in the order of
the data: the kernel's order. With ``d^2`` symmetric and row-decomposable
(``sq_dists``' fixed order) that makes these hold bit for bit: the
standard path's sum over ``[X; x]`` (the test column last) equals
``prelim_i + kv_i``, so optimized == standard, scores and p-values;
``incremental_add`` == ``fit`` on the grown data. The candidate's own
score is the kernel's row sum of the test point against the training set
(one ``kde_rowsums`` launch per read, every label's sum at once), which is
the standard path's last row. Kernel values are ``exp(-max(d^2, 0) / f32(2
h^2))``, clamped and IEEE-divided, as ``_kvals`` in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import pvalues as pv
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import kde_kvals

BLOCK_ELEMS = 2**27  # elements of one (test points, labels, n) block


def _kvals(A: torch.Tensor, B: torch.Tensor, h: float) -> torch.Tensor:
    """Gaussian kernel matrix ``(m, n)`` through ``kops.sq_dists``."""
    return kde_kvals(kops.sq_dists(A.contiguous()[None],
                                   B.contiguous()[None])[0], h)


def _scores(sums, n_y, h: float, p_dim: int):
    """``-sums / (n_y h^p)``, 0 where ``n_y == 0``."""
    return -torch.where(n_y > 0, sums / (n_y * h ** p_dim), 0.0)


def _label_counts(y, n_labels: int) -> torch.Tensor:
    labels = torch.arange(n_labels, dtype=y.dtype, device=y.device)
    return (y[None, :] == labels[:, None]).sum(1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# standard (naive) path
# ---------------------------------------------------------------------------


def scores_standard(X, y, x_test, y_hat, *, h: float, p_dim: int):
    """Naive LOO scores for one candidate, O(n^2): every row's same-label
    kernel sum over ``[X; x_test]`` without itself."""
    Xa = torch.cat([X, x_test[None]])
    ya = torch.cat([y, y.new_full((1,), int(y_hat))])
    sums = kops.kde_rowsums(Xa, Xa, ya, ya, h, exclude_diag=True)
    _, inv, cnt = torch.unique(ya, return_inverse=True, return_counts=True)
    n_y = cnt.to(torch.int32)[inv] - 1  # same-label rows, itself excluded
    s = _scores(sums, n_y, h, p_dim)
    return s[:-1], s[-1]


def pvalues_standard(X, y, X_test, *, h: float, p_dim: int, n_labels: int):
    """Naive full-CP p-values ``(m, n_labels)``."""
    out = X.new_empty((X_test.shape[0], n_labels))
    for t in range(X_test.shape[0]):
        for lbl in range(n_labels):
            alphas, alpha = scores_standard(X, y, X_test[t], lbl, h=h,
                                            p_dim=p_dim)
            out[t, lbl] = pv.pvalue(alphas, alpha)
    return out


# ---------------------------------------------------------------------------
# optimized (incremental&decremental) path
# ---------------------------------------------------------------------------


@dataclass
class KdeState:
    X: torch.Tensor  # (n, p)
    y: torch.Tensor  # (n,) int32
    prelim: torch.Tensor  # (n,) same-label kernel sums, no self
    class_counts: torch.Tensor  # (n_labels,) int32

    def leaves(self):
        return [self.X, self.y, self.prelim, self.class_counts]

    @property
    def n(self) -> int:
        return self.X.shape[0]


def fit(X, y, *, h: float, n_labels: int) -> KdeState:
    """O(n^2) training phase: one ``kde_rowsums`` launch (``n_labels``
    lets the kernel visit each row's label alone)."""
    X, y = X.contiguous(), y.contiguous()
    prelim = kops.kde_rowsums(X, X, y, y, h, exclude_diag=True,
                              n_labels=n_labels)
    return KdeState(X, y, prelim, _label_counts(y, n_labels))


def _updated_scores(state: KdeState, kv, same, h: float, p_dim: int):
    """O(1)-per-point update: add the test kernel value for same-label
    points and renormalise by the augmented class count."""
    sums = torch.where(same, state.prelim + kv, state.prelim)
    n_y = state.class_counts[state.y] - 1 + same.to(torch.int32)
    return _scores(sums, n_y, h, p_dim)


def _candidate_scores(state: KdeState, X_test, n_labels: int, h: float,
                      p_dim: int):
    """``(m, L)`` scores of every candidate: each test point's same-label
    kernel sums over the training set, every label from one pass, in the
    kernel's order."""
    sums = kops.kde_rowsums(X_test.contiguous(), state.X.contiguous(), None,
                            state.y.contiguous(), h, n_labels=n_labels)
    return _scores(sums, state.class_counts, h, p_dim)


def scores_optimized(state: KdeState, x_test, y_hat, *, h: float,
                     p_dim: int):
    """``(alphas (n,), alpha)`` for one candidate."""
    kv = _kvals(x_test[None], state.X, h)[0]
    lbl = state.y.new_full((1,), int(y_hat))
    alphas = _updated_scores(state, kv, state.y == lbl, h, p_dim)
    own = kops.kde_rowsums(x_test[None].contiguous(), state.X.contiguous(),
                           lbl, state.y.contiguous(), h)
    return alphas, _scores(own, state.class_counts[lbl.long()], h,
                           p_dim)[0]


def pvalues_optimized(state: KdeState, X_test, *, h: float, p_dim: int,
                      n_labels: int):
    """Optimized full-CP p-values ``(m, n_labels)``, O(n l) per test
    point; test points go in blocks (a row's bits do not depend on it)."""
    labels = torch.arange(n_labels, dtype=state.y.dtype,
                          device=state.y.device)
    same = state.y[None, :] == labels[:, None]  # (L, n)
    step = max(1, BLOCK_ELEMS // (n_labels * max(state.n, 1)))
    out = []
    for t0 in range(0, X_test.shape[0], step):
        Xt = X_test[t0:t0 + step]
        kv = _kvals(Xt, state.X, h)[:, None, :]  # (b, 1, n)
        alphas = _updated_scores(state, kv, same, h, p_dim)
        out.append(pv.pvalue(alphas, _candidate_scores(state, Xt, n_labels,
                                                       h, p_dim)))
    return torch.cat(out)


def incremental_add(state: KdeState, x_new, y_new, *, h: float) -> KdeState:
    """Learn one example in O(n): equals ``fit`` on the grown data, bit
    for bit (the new column comes last in every row's sum)."""
    kv = _kvals(x_new[None], state.X, h)[0]
    lbl = state.y.new_full((1,), int(y_new))
    same = state.y == lbl
    own = kops.kde_rowsums(x_new[None].contiguous(), state.X.contiguous(),
                           lbl, state.y.contiguous(), h)
    counts = state.class_counts.clone()
    counts[int(y_new)] += 1
    return KdeState(torch.cat([state.X, x_new[None]]),
                    torch.cat([state.y, lbl]),
                    torch.cat([torch.where(same, state.prelim + kv,
                                           state.prelim), own]),
                    counts)


def decremental_remove(state: KdeState, i: int, *, h: float) -> KdeState:
    """Forget point ``i`` in O(n): each same-label point sheds its kernel
    value. ``class_counts`` stay exact. Removing the point added last
    undoes ``incremental_add`` within two roundings of the pre-removal
    sums; removing an earlier point is not exact in float32 against a
    refit: the small terms a large removed value had absorbed stay lost
    (within the recursive-summation bound, about n ulp of the pre-removal
    sums). The reference subtracts the same way."""
    n = state.n
    i = int(i)
    if not -n <= i < n:
        raise IndexError(f"index {i} out of range for {n} training points")
    i %= n
    kv = _kvals(state.X[i][None], state.X, h)[0]
    same = state.y == state.y[i]
    prelim = torch.where(same, state.prelim - kv, state.prelim)
    counts = state.class_counts.clone()
    counts[int(state.y[i])] -= 1
    keep = lambda t: torch.cat([t[:i], t[i + 1:]])  # noqa: E731
    return KdeState(keep(state.X), keep(state.y), keep(prelim), counts)


__all__ = ["KdeState", "fit", "scores_standard", "pvalues_standard",
           "scores_optimized", "pvalues_optimized", "incremental_add",
           "decremental_remove"]
