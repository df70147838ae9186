"""Full k-NN CP regression (paper Section 8.1), standard and optimized.
Counterpart of ``repro/core/regression.py``; see its module docstring
for the affine scores ``alpha_i(t) = |a_i + b_i t|``, ``alpha(t) = |a +
t|`` and the critical-point sweep.

The port keeps these as its own refit oracle: ``fit`` and the
``*_optimized`` reads are what the streaming state and the served
intervals are held to bit for bit, the O(n^2) ``*_standard`` path what
the optimized one is held to. Each function takes one data set ``X (n,
p)`` (``fit`` also a batch ``(S, n, p)``). Sums over k run in fixed order
(``online.fsum``) and distances come from the fixed-order ``sq_dists``,
so a refit's bits do not depend on the batch shape. ``fit`` and
``ab_standard`` work in row blocks of at most ``BLOCK_ELEMS`` distances
(each row's sort is its own, so the blocks do not change the bits), which
lets both reach the paper's n = 100,000 on one card.
"""
from __future__ import annotations

from dataclasses import dataclass

import math

import numpy as np
import torch

from repro_torch._device import BIG, row_blocks
from repro_torch.core.online import fsum
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import div_k
from repro_torch.kernels.ref import interval_ge as _interval_ge

INF = float("inf")
BLOCK_ELEMS = 2**26  # distances in one row block of a fit or standard read


def topk_lowest(v: torch.Tensor, k: int):
    """The ``k`` smallest entries of the last axis, ascending, equal
    values in index order: ``jax.lax.top_k(-v, k)``'s tie rule, which
    ``torch.topk`` does not promise. Returns ``(values, indices)``."""
    vals, idx = torch.sort(v, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _dists(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Distances between the rows of ``A (.., m, p)`` and ``B (.., n,
    p)`` through ``kops.sq_dists`` (the pairwise kernel on the card)."""
    if A.dim() == 2:
        return _dists(A[None], B[None])[0]
    return torch.sqrt(torch.clamp(kops.sq_dists(A, B), min=0.0))


def _take(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``y[..., idx]`` per leading index: ``y (.., n)``, ``idx (.., m,
    k)`` -> ``(.., m, k)``."""
    flat = idx.flatten(-2)
    return y.gather(-1, flat).view(idx.shape)


def _neg_inv_k(like: torch.Tensor, k: int) -> torch.Tensor:
    return like.new_full((), -1.0 / k)


# ---------------------------------------------------------------------------
# shared: interval geometry + sweep
# ---------------------------------------------------------------------------


def pvalue_at(a_vec, b_vec, a, t_query):
    """Exact p-values at query labels: ``a_vec, b_vec (.., n)``, ``a
    (..)``, ``t_query (nq,)`` -> ``(.., nq)``."""
    n = a_vec.shape[-1]
    ai = (a_vec[..., None, :] + b_vec[..., None, :]
          * t_query[:, None]).abs()
    at = (a[..., None] + t_query).abs()[..., None]
    cnt = (ai >= at).sum(-1)
    # a device-scalar divisor: CUDA divides by a Python float through its
    # reciprocal, one rounding away from the served p-values and the CPU
    return (cnt + 1.0).to(a_vec.dtype) / a_vec.new_full((), n + 1.0)


def hull_sweep(lo, hi, empty, thresh):
    """Convex hull of ``{t : #{i : t in [lo_i, hi_i]} > thresh}`` over
    the last axis (``lo, hi, empty (.., n)``, ``thresh`` broadcast to
    ``(..)``); NaN where the set is empty.

    Events: +1 at each ``lo``, -1 after each ``hi``; empty intervals are
    neutral (delta 0 at +inf). The JAX sweep orders events by (point,
    -delta). One stable sort of the points of ``[lo events, hi events]``
    gives the same order at every finite point (all +1 events precede
    all -1 events at equal points) and differs only inside the +inf
    cluster, where neither the hull nor ``any_ok`` depends on the order:
    the outputs are the same bits.
    """
    pts = torch.cat([torch.where(empty, INF, lo),
                     torch.where(empty, INF, hi)], -1)
    step = (~empty).to(torch.int8)
    deltas = torch.cat([step, -step], -1)
    pts_s, order = torch.sort(pts, dim=-1, stable=True)
    runs = torch.cumsum(deltas.gather(-1, order), -1, dtype=torch.int32)
    ok = runs > torch.as_tensor(thresh, dtype=pts.dtype,
                                device=pts.device)[..., None]
    any_ok = (ok & torch.isfinite(pts_s)).any(-1)
    lo_out = torch.where(ok, pts_s, INF).amin(-1)
    nxt = torch.cat([pts_s[..., 1:], torch.full_like(pts_s[..., :1], INF)],
                    -1)
    hi_out = torch.where(ok, nxt, -INF).amax(-1)
    nan = float("nan")
    return torch.where(any_ok, lo_out, nan), torch.where(any_ok, hi_out, nan)


def _threshold(epsilon, n, like: torch.Tensor) -> torch.Tensor:
    """``epsilon * (n + 1) - 1`` in the state's float type, as the served
    read computes it (the sweep admits ``t`` where the count exceeds
    it)."""
    # Python numbers are filled on the device: no copy from the host
    eps = (epsilon.to(like) if isinstance(epsilon, torch.Tensor)
           else like.new_full((), epsilon))
    if not isinstance(n, torch.Tensor):
        n = torch.full((), n, dtype=torch.int64, device=like.device)
    return eps * (n.to(like.device) + 1.0).to(like.dtype) - 1.0


def prediction_interval(a_vec, b_vec, a, epsilon):
    """Smallest interval holding ``{t : p(t) > epsilon}`` per leading
    index: ``(lo, hi)``, each ``(..)``."""
    lo, hi = _interval_ge(a_vec, b_vec, a[..., None])
    thresh = _threshold(epsilon, a_vec.shape[-1], a_vec)
    return hull_sweep(lo, hi, lo > hi, thresh)


# ---------------------------------------------------------------------------
# standard path (Papadopoulos et al. 2011): O(n^2) per test point
# ---------------------------------------------------------------------------


def ab_standard(X, y, X_test, *, k):
    """``(a_vec (m, n), b_vec (m, n), a (m,))`` for every test row:
    each training point's k nearest neighbours recomputed in the set
    augmented by the test object (the test column last, so it loses
    distance ties to training points). The ``m * n`` augmented rows go in
    blocks, each row's distances recomputed: the O(n^2) a test point of
    the standard path, in bounded memory."""
    n, m = X.shape[0], X_test.shape[0]
    d_t = _dists(X_test, X)  # (m, n)
    cols = torch.arange(n, device=X.device)
    ya = torch.cat([y, y.new_zeros(1)])
    a_vec, b_vec = y.new_empty(m * n), y.new_empty(m * n)
    for q0, q1 in row_blocks(m * n, n + 1, BLOCK_ELEMS):
        q = torch.arange(q0, q1, device=X.device)
        j, r = q // n, q % n
        D = torch.where(cols == r[:, None], BIG, _dists(X[r], X))
        _, idx = topk_lowest(torch.cat([D, d_t[j, r][:, None]], -1), k)
        is_test = idx == n
        a_vec[q0:q1] = y[r] - div_k(fsum(torch.where(is_test, 0.0, ya[idx])),
                                    k)
        b_vec[q0:q1] = torch.where(is_test.any(-1), _neg_inv_k(y, k),
                                   y.new_full((), 0.))
    _, idx_t = topk_lowest(d_t, k)
    a = -div_k(fsum(y[idx_t]), k)
    return a_vec.view(m, n), b_vec.view(m, n), a


def pvalues_standard(X, y, X_test, t_query, *, k):
    """P-values ``(m, nq)`` at the query labels, standard path."""
    return pvalue_at(*ab_standard(X, y, X_test, k=k), t_query)


def intervals_standard(X, y, X_test, *, k, epsilon):
    """Prediction intervals ``(m, 2)``, standard path."""
    return torch.stack(prediction_interval(*ab_standard(X, y, X_test, k=k),
                                           epsilon), -1)


# ---------------------------------------------------------------------------
# optimized path (the paper): O(n^2) fit once, O(n log n) per test point
# ---------------------------------------------------------------------------


@dataclass
class KnnRegState:
    """Per-point neighbour statistics (test object unknown), rows in
    arrival order: ``a_prime = y - (1/k) sum_{j<=k} y_(j)``, the k-th
    neighbour's distance and label."""

    X: torch.Tensor  # (.., n, p)
    y: torch.Tensor  # (.., n)
    a_prime: torch.Tensor  # (.., n)
    kth_dist: torch.Tensor  # (.., n)
    kth_label: torch.Tensor  # (.., n)


def fit_lists(X, y, *, k):
    """Every point's k nearest neighbours in its own set, ascending with
    ties toward the earlier row: ``(distances, labels)``, each ``(.., n,
    k)``. The lists a streaming state must hold for this window. Rows go
    in blocks of at most ``BLOCK_ELEMS`` distances."""
    n = X.shape[-2]
    cols = torch.arange(n, device=X.device)
    knn_d = X.new_empty(X.shape[:-2] + (n, k))
    labels = y.new_empty(X.shape[:-2] + (n, k))
    per = n * (X.shape[0] if X.dim() == 3 else 1)
    for r0, r1 in row_blocks(n, per, BLOCK_ELEMS):
        eye = cols[r0:r1, None] == cols[None, :]
        D = torch.where(eye, BIG, _dists(X[..., r0:r1, :].contiguous(), X))
        knn_d[..., r0:r1, :], idx = topk_lowest(D, k)
        labels[..., r0:r1, :] = _take(y, idx)
    return knn_d, labels


def fit(X, y, *, k) -> KnnRegState:
    """O(n^2): pairwise distances + per-point k-NN label statistics."""
    knn_d, labels = fit_lists(X, y, k=k)
    a_prime = y - div_k(fsum(labels), k)
    return KnnRegState(X, y, a_prime, knn_d[..., -1], labels[..., -1])


def ab_optimized(state: KnnRegState, X_test, *, k):
    """``(a_vec (m, n), b_vec (m, n), a (m,))``: one distance row and an
    O(1) update per training point, plus the test row's own top-k."""
    d_t = _dists(X_test, state.X)
    enters = d_t < state.kth_dist
    a_vec = torch.where(enters, state.a_prime + div_k(state.kth_label, k),
                        state.a_prime)
    b_vec = torch.where(enters, _neg_inv_k(d_t, k), d_t.new_full((), 0.0))
    _, idx = topk_lowest(d_t, k)
    a = -div_k(fsum(state.y[idx]), k)
    return a_vec, b_vec, a


def pvalues_optimized(state: KnnRegState, X_test, t_query, *, k):
    """P-values ``(m, nq)`` at the query labels, optimized path."""
    return pvalue_at(*ab_optimized(state, X_test, k=k), t_query)


def intervals_optimized(state: KnnRegState, X_test, *, k, epsilon):
    """Prediction intervals ``(m, 2)``, optimized path."""
    return torch.stack(prediction_interval(
        *ab_optimized(state, X_test, k=k), epsilon), -1)


# ---------------------------------------------------------------------------
# ICP regression baseline (Papadopoulos et al. 2002)
# ---------------------------------------------------------------------------


def _knn_mean(X_ref, y_ref, X, *, k):
    """Mean label ``(m,)`` of each row of ``X``'s k nearest rows of
    ``X_ref``, ties to the lower index (JAX ``top_k``'s rule); rows in
    blocks of at most ``BLOCK_ELEMS`` distances."""
    blocks = row_blocks(X.shape[0], X_ref.shape[0], BLOCK_ELEMS)
    out = [div_k(fsum(y_ref[topk_lowest(_dists(X[r0:r1], X_ref), k)[1]]), k)
           for r0, r1 in blocks]
    return torch.cat(out) if out else y_ref.new_empty(0)


def icp_intervals(X, y, X_test, *, k, t, epsilon):
    """k-NN ICP regression intervals ``(m, 2)``: ``|y - knn_mean|`` scores
    of the calibration rows ``Z[t:]`` against the proper training set
    ``Z[:t]``; the interval is ``knn_mean(x) -+ q``, ``q`` the
    ``ceil((1 - eps)(n_cal + 1))``-th smallest score (clipped to the
    set), the rank computed in float32 as the JAX package does."""
    X_tr, y_tr = X[:t], y[:t]
    scores = (y[t:] - _knn_mean(X_tr, y_tr, X[t:], k=k)).abs()
    n_cal = scores.shape[0]
    rank = math.ceil(np.float32((1.0 - epsilon) * (n_cal + 1))) - 1
    qhat = torch.sort(scores).values[min(max(rank, 0), n_cal - 1)]
    mu = _knn_mean(X_tr, y_tr, X_test, k=k)
    return torch.stack([mu - qhat, mu + qhat], 1)


__all__ = ["BIG", "topk_lowest", "pvalue_at", "hull_sweep",
           "prediction_interval", "ab_standard", "pvalues_standard",
           "intervals_standard", "KnnRegState", "fit", "fit_lists",
           "ab_optimized", "pvalues_optimized", "intervals_optimized",
           "icp_intervals"]
