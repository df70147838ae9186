"""Kernel LS-SVM nonconformity measure (paper Section 5, Appendix B).

Counterpart of ``repro/core/measures/lssvm.py``: ``A((x, y); S) = -y
w_S . phi(x)`` with ``w_S`` ridge-trained on ``S`` and ``phi`` an explicit
feature map. The standard path retrains per LOO entry; the optimized path
(Lee et al. 2019) trains ``w, C`` once and per candidate does one
incremental rank-1 update and the vectorized LOO decrement

    alpha_i = -y_i (rho u_i + (s_i - t_i) y_i) / (rho + s_i - t_i).

Plain ``torch.linalg`` / ``torch.matmul``, as the reference leaves these to
XLA outside any Pallas kernel. TF32 is off for every product
(``torch.backends.cuda.matmul.allow_tf32 = False``, set on entry): it
keeps about three decimal digits, too few for the LOO scores.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core import pvalues as pv

LOO_BLOCK = 256  # LOO retrainings batched in one solve (a (256, n, q) mask)


def _full_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# feature maps (finite-q kernels)
# ---------------------------------------------------------------------------


def rff_params(p: int, q: int, seed: int = 0, device=None):
    """``W (p, q)`` standard normal and ``b (q,)`` uniform on ``[0, 2 pi)``
    from a ``torch.Generator`` (the reference draws its own with
    ``jax.random``; ``serving.convert.rff_params_from_numpy`` carries
    those across)."""
    g = torch.Generator().manual_seed(seed)
    W = torch.randn((p, q), generator=g)
    b = torch.rand((q,), generator=g) * (2 * math.pi)
    return W.to(device), b.to(device)


def feature_map(kind: str, p: int, q: int = 0, seed: int = 0, device=None,
                params=None):
    """``(phi, q_out)`` with ``phi: (n, p) -> (n, q_out)``. ``params``
    gives the ``rff`` map's ``(W, b)`` (default: ``rff_params``)."""
    if kind == "linear":
        return (lambda X: X), p
    if kind == "poly2":
        iu = torch.triu_indices(p, p)

        def phi(X):
            r, c = iu.to(X.device)
            quad = (X[:, :, None] * X[:, None, :])[:, r, c]
            return torch.cat([X, quad], 1)

        return phi, p + p * (p + 1) // 2
    if kind == "rff":
        W, b = rff_params(p, q, seed, device) if params is None else params
        scale = math.sqrt(2.0 / q)

        def phi(X):
            return scale * torch.cos(X @ W + b)

        return phi, q
    raise ValueError(f"unknown feature map {kind!r}")


# ---------------------------------------------------------------------------
# standard (naive) path
# ---------------------------------------------------------------------------


def _eye(q: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(q, dtype=like.dtype, device=like.device)


def _train_w(Phi, Y, rho: float):
    """Ridge weights; ``Phi (.., n, q)``, ``Y (.., n)``."""
    A = Phi.mT @ Phi + rho * _eye(Phi.shape[-1], Phi)
    return torch.linalg.solve(A, (Phi.mT @ Y[..., None]))[..., 0]


def scores_standard(Phi, Y, phi_test, y_hat, *, rho: float):
    """Naive LOO: retrain from scratch per left-out point, in blocks of
    ``LOO_BLOCK`` entries. Returns ``(alphas (n,), alpha)``."""
    _full_f32()
    n = Phi.shape[0]
    Phi_a = torch.cat([Phi, phi_test[None]])
    Y_a = torch.cat([Y, Y.new_full((1,), float(y_hat))])
    idx = torch.arange(n + 1, device=Phi.device)
    scores = []
    for r0 in range(0, n + 1, LOO_BLOCK):
        r = idx[r0:r0 + LOO_BLOCK]
        mask = (idx[None, :] != r[:, None])  # (b, n + 1)
        w = _train_w(torch.where(mask[..., None], Phi_a, 0.0),
                     torch.where(mask, Y_a, 0.0), rho)  # (b, q)
        scores.append(-Y_a[r] * (Phi_a[r] * w).sum(-1))
    s = torch.cat(scores)
    return s[:n], s[n]


def pvalues_standard(Phi, Y, Phi_test, *, rho: float):
    """Naive full-CP p-values for binary labels ``(-1, +1)``: ``(m, 2)``."""
    out = Phi.new_empty((Phi_test.shape[0], 2))
    for t in range(Phi_test.shape[0]):
        for c, y_hat in enumerate((-1.0, 1.0)):
            alphas, alpha = scores_standard(Phi, Y, Phi_test[t], y_hat,
                                            rho=rho)
            out[t, c] = pv.pvalue(alphas, alpha)
    return out


# ---------------------------------------------------------------------------
# optimized (incremental&decremental, Lee et al. 2019) path
# ---------------------------------------------------------------------------


@dataclass
class LssvmState:
    Phi: torch.Tensor  # (n, q) feature-mapped training set
    Y: torch.Tensor  # (n,) labels in {-1, +1}
    w: torch.Tensor  # (q,) trained model
    C: torch.Tensor  # (q, q) auxiliary matrix of Lee et al.
    rho: torch.Tensor  # () regularizer

    def leaves(self):
        return [self.Phi, self.Y, self.w, self.C, self.rho]

    @property
    def n(self) -> int:
        return self.Phi.shape[0]


def fit(Phi, Y, rho) -> LssvmState:
    """One-off O(n q^2 + q^3) training."""
    _full_f32()
    q = Phi.shape[1]
    A = Phi.T @ Phi + rho * _eye(q, Phi)
    Ainv = torch.linalg.inv(A)
    w = Ainv @ (Phi.T @ Y)
    C = _eye(q, Phi) - rho * Ainv
    return LssvmState(Phi, Y, w, C, Phi.new_full((), float(rho)))


def incremental_add(state: LssvmState, phi_new, y_new) -> LssvmState:
    """Lee et al. incremental update, O(q^2)."""
    _full_f32()
    C, w, rho = state.C, state.w, state.rho
    Cphi = (C - _eye(C.shape[0], C)) @ phi_new
    denom = phi_new @ phi_new + rho - phi_new @ C @ phi_new
    w_new = w + Cphi * (phi_new @ w - y_new) / denom
    C_new = C + torch.outer(Cphi, Cphi) / denom
    return LssvmState(torch.cat([state.Phi, phi_new[None]]),
                      torch.cat([state.Y, state.Y.new_full((1,),
                                                           float(y_new))]),
                      w_new, C_new, rho)


def _downdate(state: LssvmState, phi_i, y_i):
    """Shared removal terms: ``(Cphi, denom, downdated w)``."""
    C, w, rho = state.C, state.w, state.rho
    Cphi = (C - _eye(C.shape[0], C)) @ phi_i
    denom = -phi_i @ phi_i + rho + phi_i @ C @ phi_i
    return Cphi, denom, w - Cphi * (phi_i @ w - y_i) / denom


def decremental_remove_w(state: LssvmState, phi_i, y_i) -> torch.Tensor:
    """Lee et al. decremental update of ``w`` only, O(q^2)."""
    _full_f32()
    return _downdate(state, phi_i, y_i)[2]


def decremental_remove(state: LssvmState, i: int) -> LssvmState:
    """Forget point ``i``: Sherman-Morrison downdate of ``w`` and ``C``,
    the exact inverse of ``incremental_add``."""
    _full_f32()
    n = state.n
    i = int(i)
    if not -n <= i < n:
        raise IndexError(f"index {i} out of range for {n} training points")
    i %= n
    Cphi, denom, w_new = _downdate(state, state.Phi[i], state.Y[i])
    C_new = state.C - torch.outer(Cphi, Cphi) / denom
    keep = lambda t: torch.cat([t[:i], t[i + 1:]])  # noqa: E731
    return LssvmState(keep(state.Phi), keep(state.Y), w_new, C_new,
                      state.rho)


def _diag_quad(Phi, C):
    """``diag(Phi C Phi^T)``."""
    return ((Phi @ C) * Phi).sum(-1)


def loo_scores(state: LssvmState) -> torch.Tensor:
    """LOO scores ``alpha_i = -y_i w_{-i} . phi_i`` for all ``i`` at once:
    three products, O(n q^2)."""
    _full_f32()
    Phi, Y, w, C, rho = state.Phi, state.Y, state.w, state.C, state.rho
    u = Phi @ w
    s = _diag_quad(Phi, C)
    t = (Phi * Phi).sum(1)
    return -Y * (rho * u + (s - t) * Y) / (rho + s - t)


def scores_optimized(state: LssvmState, phi_test, y_hat):
    """``(alphas, alpha)`` for one candidate: one incremental add and the
    batched LOO."""
    alpha = -y_hat * (phi_test @ state.w)
    st_plus = incremental_add(state, phi_test, y_hat)
    return loo_scores(st_plus)[:-1], alpha


def pvalues_optimized(state: LssvmState, Phi_test):
    """Optimized full-CP p-values for binary labels ``(-1, +1)``: ``(m,
    2)``. ``C+``, ``s`` and ``t`` are label-independent and shared by both
    candidate labels; only ``u = Phi w+`` is per label."""
    _full_f32()
    Phi, Y, w, C, rho = state.Phi, state.Y, state.w, state.C, state.rho
    n, q = Phi.shape
    Iq = _eye(q, C)
    out = Phi.new_empty((Phi_test.shape[0], 2))
    for m, phi_t in enumerate(Phi_test):
        Cphi = (C - Iq) @ phi_t
        denom_add = phi_t @ phi_t + rho - phi_t @ C @ phi_t
        C_plus = C + torch.outer(Cphi, Cphi) / denom_add
        Phi_a = torch.cat([Phi, phi_t[None]])
        s = _diag_quad(Phi_a, C_plus)
        t = (Phi_a * Phi_a).sum(1)
        denom = rho + s - t
        fw = phi_t @ w
        for c, y_hat in enumerate((-1.0, 1.0)):
            w_plus = w + Cphi * (fw - y_hat) / denom_add
            Y_a = torch.cat([Y, Y.new_full((1,), y_hat)])
            u = Phi_a @ w_plus
            alphas = (-Y_a * (rho * u + (s - t) * Y_a) / denom)[:n]
            out[m, c] = pv.pvalue(alphas, -y_hat * fw)
    return out


__all__ = ["feature_map", "rff_params", "LssvmState", "fit",
           "scores_standard", "pvalues_standard", "scores_optimized",
           "pvalues_optimized", "incremental_add", "decremental_remove",
           "decremental_remove_w", "loo_scores"]
