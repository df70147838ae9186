"""High-level conformal prediction API of the port.

Counterpart of ``repro/core/predictor.py``. ``ConformalClassifier`` is
the user-facing entry point: the paper-optimized path by default, the
naive one with ``optimized=False``.

    clf = ConformalClassifier(measure="knn", k=15, n_labels=2)
    clf.fit(X, y)
    p = clf.predict_pvalues(X_test)          # (m, l)
    sets = clf.predict_set(X_test, eps=0.1)  # (m, l) bool

Measures: "knn", "simplified_knn", "kde", "lssvm" (binary), "bootstrap"
(Algorithm 3: its pool and p-value arithmetic on the host, its forests on
``device``). ``InductiveConformalClassifier`` is the ICP baseline with
the same surface. Inputs become float32 and int32 tensors on ``device``
(``cuda`` unless the caller asks for another; it raises without a GPU).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch._device import as_tensor as _tensor
from repro_torch._device import resolve
from repro_torch.core import icp as icp_m
from repro_torch.core import pvalues as pv
from repro_torch.core.measures import bootstrap as boot_m
from repro_torch.core.measures import kde as kde_m
from repro_torch.core.measures import knn as knn_m
from repro_torch.core.measures import lssvm as lssvm_m

MEASURES = ("knn", "simplified_knn", "kde", "lssvm", "bootstrap")


def _to_pm1(y: torch.Tensor) -> torch.Tensor:
    return 2.0 * y.to(torch.float32) - 1.0


def _check_measure(measure: str, n_labels: int) -> None:
    if measure not in MEASURES:
        raise ValueError(f"measure {measure!r} not in {MEASURES}")
    if measure == "lssvm" and n_labels != 2:
        raise ValueError("lssvm measure is binary (labels {-1,+1}); use "
                         "one-vs-rest for more labels (paper Section 5)")


@dataclass
class ConformalClassifier:
    """Full (transductive) CP classifier; exact optimized path by default."""

    measure: str = "knn"
    n_labels: int = 2
    k: int = 15
    h: float = 1.0  # KDE bandwidth
    rho: float = 1.0  # LS-SVM regularizer
    feature_map: str = "linear"  # LS-SVM phi
    rff_dim: int = 128
    B: int = 10  # bootstrap ensemble size
    tree_depth: int = 5
    optimized: bool = True
    seed: int = 0
    device: Any = None
    _state: Any = field(default=None, repr=False)
    _fitdata: Any = field(default=None, repr=False)
    _phi: Any = field(default=None, repr=False)

    def __post_init__(self):
        _check_measure(self.measure, self.n_labels)
        self.device = resolve(self.device)

    def fit(self, X, y) -> "ConformalClassifier":
        X = _tensor(X, torch.float32, self.device)
        y = _tensor(y, torch.int32, self.device)
        self._fitdata = (X, y)
        if self.measure == "lssvm":
            self._phi, _ = lssvm_m.feature_map(
                self.feature_map, X.shape[1], self.rff_dim, self.seed,
                device=self.device)
        if not self.optimized:
            return self  # standard full CP has no training phase
        if self.measure in ("knn", "simplified_knn"):
            self._state = knn_m.fit(X, y, k=self.k)
        elif self.measure == "kde":
            self._state = kde_m.fit(X, y, h=self.h, n_labels=self.n_labels)
        elif self.measure == "bootstrap":
            self._state = boot_m.fit(
                X.cpu().numpy(), y.cpu().numpy(), n_labels=self.n_labels,
                B=self.B, depth=self.tree_depth, seed=self.seed,
                device=self.device)
        else:
            self._state = lssvm_m.fit(self._phi(X), _to_pm1(y), self.rho)
        return self

    def predict_pvalues(self, X_test) -> torch.Tensor:
        X_test = _tensor(X_test, torch.float32, self.device)
        X, y = self._fitdata
        if self.measure in ("knn", "simplified_knn"):
            kw = dict(k=self.k, simplified=self.measure == "simplified_knn",
                      n_labels=self.n_labels)
            if self.optimized:
                return knn_m.pvalues_optimized(self._state, X_test, **kw)
            return knn_m.pvalues_standard(X, y, X_test, **kw)
        if self.measure == "kde":
            kw = dict(h=self.h, p_dim=X.shape[1], n_labels=self.n_labels)
            if self.optimized:
                return kde_m.pvalues_optimized(self._state, X_test, **kw)
            return kde_m.pvalues_standard(X, y, X_test, **kw)
        if self.measure == "bootstrap":
            if self.optimized:
                p = boot_m.pvalues_optimized(self._state,
                                             X_test.cpu().numpy())
            else:
                p = boot_m.pvalues_standard(
                    X.cpu().numpy(), y.cpu().numpy(), X_test.cpu().numpy(),
                    n_labels=self.n_labels, B=self.B, depth=self.tree_depth,
                    seed=self.seed, device=self.device)
            return torch.as_tensor(p, dtype=torch.float32,
                                   device=self.device)
        if self.optimized:
            return lssvm_m.pvalues_optimized(self._state, self._phi(X_test))
        return lssvm_m.pvalues_standard(self._phi(X), _to_pm1(y),
                                        self._phi(X_test), rho=self.rho)

    def predict_set(self, X_test, eps: float) -> torch.Tensor:
        return pv.prediction_sets(self.predict_pvalues(X_test), eps)

    def predict_point(self, X_test) -> torch.Tensor:
        """Point prediction: argmax p-value (forced single label)."""
        return torch.argmax(self.predict_pvalues(X_test), dim=-1)


@dataclass
class InductiveConformalClassifier:
    """ICP baseline (paper Section 2.3); same surface as the full CP class."""

    measure: str = "knn"
    n_labels: int = 2
    k: int = 15
    h: float = 1.0
    rho: float = 1.0
    feature_map: str = "linear"
    rff_dim: int = 128
    train_frac: float = 0.5
    seed: int = 0
    device: Any = None
    _state: Any = field(default=None, repr=False)
    _phi: Any = field(default=None, repr=False)
    _pdim: int = 0

    def __post_init__(self):
        if self.measure not in ("knn", "simplified_knn", "kde", "lssvm"):
            raise ValueError(f"ICP measure {self.measure!r} unsupported")
        self.device = resolve(self.device)

    def fit(self, X, y) -> "InductiveConformalClassifier":
        X = _tensor(X, torch.float32, self.device)
        y = _tensor(y, torch.int32, self.device)
        t = max(1, int(X.shape[0] * self.train_frac))
        self._pdim = X.shape[1]
        if self.measure in ("knn", "simplified_knn"):
            self._state = icp_m.fit_knn(
                X, y, k=self.k, simplified=self.measure == "simplified_knn",
                t=t)
        elif self.measure == "kde":
            self._state = icp_m.fit_kde(X, y, h=self.h, p_dim=self._pdim,
                                        n_labels=self.n_labels, t=t)
        else:
            self._phi, _ = lssvm_m.feature_map(
                self.feature_map, self._pdim, self.rff_dim, self.seed,
                device=self.device)
            self._state = icp_m.fit_lssvm(self._phi(X), _to_pm1(y),
                                          self.rho, t=t)
        return self

    def predict_pvalues(self, X_test) -> torch.Tensor:
        X_test = _tensor(X_test, torch.float32, self.device)
        if self.measure in ("knn", "simplified_knn"):
            return icp_m.pvalues_knn(
                self._state, X_test, k=self.k,
                simplified=self.measure == "simplified_knn",
                n_labels=self.n_labels)
        if self.measure == "kde":
            return icp_m.pvalues_kde(self._state, X_test, h=self.h,
                                     p_dim=self._pdim,
                                     n_labels=self.n_labels)
        return icp_m.pvalues_lssvm(self._state, self._phi(X_test))

    def predict_set(self, X_test, eps: float) -> torch.Tensor:
        return pv.prediction_sets(self.predict_pvalues(X_test), eps)


__all__ = ["ConformalClassifier", "InductiveConformalClassifier", "MEASURES"]
