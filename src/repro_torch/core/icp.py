"""Inductive Conformal Prediction (paper Section 2.3, Appendix A,
Algorithm 2), the computational baseline.

Counterpart of ``repro/core/icp.py``: train the measure once on the
proper training set ``Z[:t]``, score the calibration set ``Z[t:]`` once,
and price every candidate against those fixed scores, ``p = (#{alpha_i >=
alpha} + 1) / (n - t + 1)``. k-NN uses row-difference distances as the
reference does (``ref.row_dists``); KDE's kernel sums are
``kops.kde_rowsums`` (the hand kernel on the card, the pairwise form of
``d^2``); LS-SVM is plain ``torch.linalg``. Calibration and test points
go in blocks, so no ``(n - t, t)`` tensor is held whole.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch._device import row_blocks
from repro_torch.core import pvalues as pv
from repro_torch.core.measures import knn as knn_m
from repro_torch.core.measures import lssvm as lssvm_m
from repro_torch.core.online import fsum
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import row_dists

def icp_pvalue(calib_scores: torch.Tensor, alpha: torch.Tensor):
    """ICP p-value; broadcasts over the leading dims of ``alpha``."""
    return pv.pvalue(calib_scores, alpha)


# ---------------------------------------------------------------------------
# k-NN ICP
# ---------------------------------------------------------------------------


@dataclass
class IcpKnnState:
    X_train: torch.Tensor  # (t, p) proper training set
    y_train: torch.Tensor  # (t,)
    calib_scores: torch.Tensor  # (n - t,)

    def leaves(self):
        return [self.X_train, self.y_train, self.calib_scores]


def _knn_scores_against(X_ref, y_ref, X, y_hat, *, k: int,
                        simplified: bool):
    """``A((x, y_hat); reference set)`` for rows ``X (b, p)`` and labels
    ``y_hat (b, L)`` -> ``(b, L)``."""
    d = row_dists(X_ref[None], X)[:, None, :]  # (b, 1, t)
    same = y_ref == y_hat[..., None]  # (b, L, t)
    num = fsum(knn_m._k_best(d, same, k))
    if simplified:
        return num
    return num / fsum(knn_m._k_best(d, ~same, k))


def fit_knn(X, y, *, k: int, simplified: bool, t: int) -> IcpKnnState:
    """Train on ``Z[:t]``, score ``Z[t:]`` against it."""
    X_tr, y_tr = X[:t], y[:t]
    blocks = row_blocks(X.shape[0] - t, t, knn_m.BLOCK_ELEMS)
    scores = [_knn_scores_against(X_tr, y_tr, X[t + a:t + b],
                                  y[t + a:t + b, None], k=k,
                                  simplified=simplified)[:, 0]
              for a, b in blocks]
    return IcpKnnState(X_tr, y_tr, torch.cat(scores))


def pvalues_knn(state: IcpKnnState, X_test, *, k: int, simplified: bool,
                n_labels: int):
    labels = torch.arange(n_labels, dtype=state.y_train.dtype,
                          device=state.y_train.device)
    out = [icp_pvalue(state.calib_scores, _knn_scores_against(
        state.X_train, state.y_train, X_test[a:b],
        labels.expand(b - a, n_labels), k=k, simplified=simplified))
        for a, b in row_blocks(X_test.shape[0],
                               n_labels * state.X_train.shape[0],
                               knn_m.BLOCK_ELEMS)]
    return torch.cat(out)


# ---------------------------------------------------------------------------
# KDE ICP
# ---------------------------------------------------------------------------


@dataclass
class IcpKdeState:
    X_train: torch.Tensor
    y_train: torch.Tensor
    class_counts: torch.Tensor  # (n_labels,) counts in the proper set
    calib_scores: torch.Tensor

    def leaves(self):
        return [self.X_train, self.y_train, self.class_counts,
                self.calib_scores]


def _kde_scores_against(X_ref, y_ref, counts, X, y_hat, *, h: float,
                        p_dim: int, n_labels: int):
    """Scores of rows ``X (b, p)`` with labels ``y_hat (b,)`` int32."""
    sums = kops.kde_rowsums(X.contiguous(), X_ref.contiguous(),
                            y_hat.contiguous(), y_ref.contiguous(), h,
                            n_labels=n_labels)
    c = counts[y_hat.long()]
    return -torch.where(c > 0, sums / (c * h ** p_dim), 0.0)


def fit_kde(X, y, *, h: float, p_dim: int, n_labels: int,
            t: int) -> IcpKdeState:
    X_tr, y_tr = X[:t], y[:t]
    labels = torch.arange(n_labels, dtype=y.dtype, device=y.device)
    counts = (y_tr[None, :] == labels[:, None]).sum(1, dtype=torch.int32)
    scores = _kde_scores_against(X_tr, y_tr, counts, X[t:].contiguous(),
                                 y[t:].contiguous(), h=h, p_dim=p_dim,
                                 n_labels=n_labels)
    return IcpKdeState(X_tr, y_tr, counts, scores)


def pvalues_kde(state: IcpKdeState, X_test, *, h: float, p_dim: int,
                n_labels: int):
    sums = kops.kde_rowsums(X_test.contiguous(), state.X_train.contiguous(),
                            None, state.y_train.contiguous(), h,
                            n_labels=n_labels)
    c = state.class_counts
    a = -torch.where(c > 0, sums / (c * h ** p_dim), 0.0)
    return icp_pvalue(state.calib_scores, a)


# ---------------------------------------------------------------------------
# LS-SVM ICP (binary, labels in {-1, +1})
# ---------------------------------------------------------------------------


@dataclass
class IcpLssvmState:
    w: torch.Tensor  # (q,) model trained on the proper set
    calib_scores: torch.Tensor

    def leaves(self):
        return [self.w, self.calib_scores]


def fit_lssvm(Phi, Y, rho: float, *, t: int) -> IcpLssvmState:
    lssvm_m._full_f32()
    w = lssvm_m._train_w(Phi[:t], Y[:t], rho)
    return IcpLssvmState(w, -Y[t:] * (Phi[t:] @ w))


def pvalues_lssvm(state: IcpLssvmState, Phi_test):
    lssvm_m._full_f32()
    labels = Phi_test.new_tensor([-1.0, 1.0])
    alphas = -labels[None, :] * (Phi_test @ state.w)[:, None]  # (m, 2)
    return icp_pvalue(state.calib_scores, alphas)


__all__ = ["icp_pvalue", "IcpKnnState", "fit_knn", "pvalues_knn",
           "IcpKdeState", "fit_kde", "pvalues_kde", "IcpLssvmState",
           "fit_lssvm", "pvalues_lssvm"]
