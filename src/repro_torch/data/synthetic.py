"""Synthetic data, the port's own copy.

``make_classification``, ``make_regression`` and ``train_test_split``
repeat ``repro/data/synthetic.py``'s numpy recipes draw for draw
(sklearn's: class centroids on the vertices of a hypercube in an
``n_informative``-dim subspace, random linear mixing into redundant
features, gaussian noise; a random sparse linear model), so the same seed
gives the same arrays in both packages. All are deterministic in ``seed``.
"""
from __future__ import annotations

import numpy as np


def make_classification(
    n_samples: int = 100,
    n_features: int = 30,
    n_informative: int = 10,
    n_classes: int = 2,
    class_sep: float = 1.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    n_informative = min(n_informative, n_features)
    y = rng.integers(0, n_classes, size=n_samples)
    # class centroids: random hypercube vertices scaled by class_sep
    centroids = (rng.integers(0, 2, size=(n_classes, n_informative)) * 2 - 1).astype(
        np.float64
    ) * class_sep
    X_inf = rng.standard_normal((n_samples, n_informative)) + centroids[y]
    if n_features > n_informative:
        # redundant/noise features: random linear combos + pure noise
        n_extra = n_features - n_informative
        mix = rng.standard_normal((n_informative, n_extra))
        X_extra = X_inf @ mix * 0.3 + rng.standard_normal((n_samples, n_extra))
        X = np.concatenate([X_inf, X_extra], axis=1)
    else:
        X = X_inf
    perm = rng.permutation(n_features)
    return X[:, perm].astype(np.float64), y.astype(np.int32)


def make_regression(
    n_samples: int = 100,
    n_features: int = 30,
    n_informative: int = 10,
    noise: float = 1.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    n_informative = min(n_informative, n_features)
    X = rng.standard_normal((n_samples, n_features))
    w = np.zeros(n_features)
    w[:n_informative] = rng.standard_normal(n_informative) * 10.0
    y = X @ w + noise * rng.standard_normal(n_samples)
    return X.astype(np.float64), y.astype(np.float64)


def train_test_split(X, y, test_frac: float = 0.3, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = len(X)
    perm = rng.permutation(n)
    n_test = int(n * test_frac)
    te, tr = perm[:n_test], perm[n_test:]
    return X[tr], y[tr], X[te], y[te]
