"""Declarative nonconformity-measure registry, the port's counterpart of
``repro/serving/registry.py``.

The paper's incrementally-and-decrementally optimized measures behind one
``fit / observe / evict / pvalues`` surface (regression measures add an
``intervals`` hook)::

    from repro_torch.serving import registry

    cp = registry.ConformalPredictor("kde", h=0.8, n_labels=3)
    cp.fit(X, y)
    cp.observe(x_new, y_new)      # paper's incremental update, O(n)
    cp.evict(0)                   # paper's decremental update, O(n)
    p = cp.pvalues(X_test)        # (m, n_labels) full-CP p-values

Registered: knn, simplified_knn, kde, lssvm, bootstrap and knn_regression
(streaming k-NN regression, paper Section 8.1: ``cp.intervals(X_test,
eps)``, or ``pvalues`` at a ``t_query`` label grid). ``fit`` returns
``(state, ctx)``; ``ctx`` carries non-tensor companions (the LS-SVM
feature map, the bootstrap draw stream) and every other hook receives it
back. Each spec's ``fit`` casts the labels it is given, as the JAX specs
do: int32 for the classifiers, float32 for regression. Predictors run on
``device`` (``cuda`` unless the caller asks for another; it raises
without a GPU).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch._device import BIG, resolve
from repro_torch._device import as_tensor as _tensor
from repro_torch.core import pvalues as pv
from repro_torch.core.measures import bootstrap as boot_m
from repro_torch.core.measures import kde as kde_m
from repro_torch.core.measures import knn as knn_m
from repro_torch.core.measures import lssvm as lssvm_m
from repro_torch.regression import session as rsession
from repro_torch.regression import stream as rstream


@dataclass(frozen=True)
class MeasureSpec:
    """One pluggable nonconformity measure (all hooks take the hp dict)."""

    name: str
    fit: Callable[..., tuple[Any, Any]]  # (X, y, hp) -> (state, ctx)
    observe: Callable[..., Any]  # (state, ctx, x, y, hp) -> state
    evict: Callable[..., Any] | None  # (state, ctx, i, hp) -> state
    pvalues: Callable[..., torch.Tensor]  # (state, ctx, X_test, hp)
    defaults: dict
    # regression measures: (state, ctx, X_test, epsilon, hp) -> (m, 2)
    intervals: Callable[..., torch.Tensor] | None = None


_REGISTRY: dict[str, MeasureSpec] = {}


def register(spec: MeasureSpec) -> MeasureSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> MeasureSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown measure {name!r}; registered: {available()}") from None


def available() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# built-in measures
# ---------------------------------------------------------------------------


def _knn_spec(name: str, simplified: bool) -> MeasureSpec:
    def fit(X, y, hp):
        return knn_m.fit(X, y.to(torch.int32), k=hp["k"]), None

    def observe(state, ctx, x, y, hp):
        return knn_m.incremental_add(state, x, int(y), k=hp["k"])

    def evict(state, ctx, i, hp):
        return knn_m.decremental_remove(state, i, k=hp["k"])

    def pvalues(state, ctx, X_test, hp):
        return knn_m.pvalues_optimized(
            state, X_test, k=hp["k"], simplified=simplified,
            n_labels=hp["n_labels"])

    return MeasureSpec(name, fit, observe, evict, pvalues,
                       defaults={"k": 7, "n_labels": 2})


def _kde_spec() -> MeasureSpec:
    def fit(X, y, hp):
        return kde_m.fit(X, y.to(torch.int32), h=hp["h"],
                         n_labels=hp["n_labels"]), None

    def observe(state, ctx, x, y, hp):
        return kde_m.incremental_add(state, x, int(y), h=hp["h"])

    def evict(state, ctx, i, hp):
        return kde_m.decremental_remove(state, i, h=hp["h"])

    def pvalues(state, ctx, X_test, hp):
        return kde_m.pvalues_optimized(
            state, X_test, h=hp["h"], p_dim=state.X.shape[1],
            n_labels=hp["n_labels"])

    return MeasureSpec("kde", fit, observe, evict, pvalues,
                       defaults={"h": 1.0, "n_labels": 2})


def _lssvm_spec() -> MeasureSpec:
    # binary measure: int labels {0, 1} are mapped to {-1, +1}

    def fit(X, y, hp):
        if hp["n_labels"] != 2:
            raise ValueError(
                "lssvm measure is binary (labels {0, 1}); use one-vs-rest "
                "for more labels (paper Section 5)")
        if not bool(((y == 0) | (y == 1)).all()):
            raise ValueError("lssvm measure expects labels in {0, 1}")
        phi, _ = lssvm_m.feature_map(hp["feature_map"], X.shape[1],
                                     hp["rff_dim"], hp["seed"],
                                     device=X.device)
        return lssvm_m.fit(phi(X), 2.0 * y.to(torch.float32) - 1.0,
                           hp["rho"]), phi

    def observe(state, phi, x, y, hp):
        y = int(y)
        if y not in (0, 1):
            raise ValueError("lssvm measure expects labels in {0, 1}")
        return lssvm_m.incremental_add(state, phi(x[None])[0], 2.0 * y - 1.0)

    def evict(state, phi, i, hp):
        return lssvm_m.decremental_remove(state, i)

    def pvalues(state, phi, X_test, hp):
        return lssvm_m.pvalues_optimized(state, phi(X_test))

    return MeasureSpec("lssvm", fit, observe, evict, pvalues,
                       defaults={"rho": 1.0, "feature_map": "linear",
                                 "rff_dim": 128, "seed": 0, "n_labels": 2})


def _bootstrap_spec() -> MeasureSpec:
    """Bootstrap CP (paper Section 6, Algorithm 3) served online.

    The state is the host-side shared-sample-pool ``BootstrapState``, its
    forests on the predictor's device; ``ctx`` is the measure's keyed
    ``DrawStream``, the RNG stream ``observe`` / ``evict`` consume for
    fresh bootstrap draws (keyed by draw id, so identical histories give
    identical states). Both updates are exact against a from-scratch
    build on the same effective sample set (``bootstrap.rebuild``).
    """

    def fit(X, y, hp):
        stream = boot_m.DrawStream(hp["seed"])
        state = boot_m.fit(
            X.cpu().numpy(), y.to(torch.int32).cpu().numpy(),
            n_labels=hp["n_labels"],
            B=hp["B"], depth=hp["depth"], seed=hp["seed"],
            max_bprime=hp["max_bprime"], stream=stream, device=X.device)
        return state, stream

    def observe(state, stream, x, y, hp):
        return boot_m.incremental_add(state, x.cpu().numpy(), int(y),
                                      stream=stream)

    def evict(state, stream, i, hp):
        return boot_m.decremental_remove(state, int(i), stream=stream)

    def pvalues(state, stream, X_test, hp):
        return torch.as_tensor(
            boot_m.pvalues_optimized(state, X_test.cpu().numpy()),
            dtype=torch.float32, device=state.device)

    return MeasureSpec("bootstrap", fit, observe, evict, pvalues,
                       defaults={"n_labels": 2, "B": 10, "depth": 5,
                                 "seed": 0, "max_bprime": 100000})


def _knn_regression_spec() -> MeasureSpec:
    """Streaming k-NN regression CP (paper Section 8.1).

    The state is a ``RegStreamState`` without the tenant axis (the JAX
    registry's shapes) with capacity == n, kept linear (head 0, the ring
    never wraps), so growing or shrinking it by a row moves the ring
    modulus along; each hook lends it to the batched stream functions as
    one tenant. ``pvalues`` evaluates p(t) at the ``t_query`` label grid;
    ``intervals`` is the natural read path.
    """

    def _one(st):  # the registry's state as a batch of one tenant
        return rstream.RegStreamState.from_leaves(
            [t[None] for t in st.leaves()])

    def _own(st):
        return rstream.RegStreamState.from_leaves(
            [t[0] for t in st.leaves()])

    def _pad_one(st):
        return rstream.RegStreamState(
            X=F.pad(st.X, (0, 0, 0, 1)), y=F.pad(st.y, (0, 1)),
            D=F.pad(st.D, (0, 1, 0, 1), value=BIG),
            nbr_d=F.pad(st.nbr_d, (0, 0, 0, 1), value=BIG),
            nbr_y=F.pad(st.nbr_y, (0, 0, 0, 1)), n=st.n, head=st.head,
            aid=F.pad(st.aid, (0, 1)), wrap=st.wrap + 1,
            nbr_a=F.pad(st.nbr_a, (0, 0, 0, 1)))

    def _shrink_one(st):
        return rstream.RegStreamState(
            X=st.X[:-1], y=st.y[:-1], D=st.D[:-1, :-1].contiguous(),
            nbr_d=st.nbr_d[:-1], nbr_y=st.nbr_y[:-1], n=st.n, head=st.head,
            aid=st.aid[:-1], wrap=st.wrap - 1, nbr_a=st.nbr_a[:-1])

    def fit(X, y, hp):
        st = rstream.from_fit(X[None], y.to(torch.float32)[None], k=hp["k"],
                              capacity=X.shape[0], device=X.device)
        return _own(st), None

    def observe(state, ctx, x, y, hp):
        y = _tensor(y, torch.float32, x.device).reshape(1)
        st, _ = rstream.observe(_one(_pad_one(state)), x[None], y,
                                k=hp["k"])
        return _own(st)

    def evict(state, ctx, i, hp):
        n, i = int(state.n), int(i)
        if not -n <= i < n:
            raise IndexError(
                f"index {i} out of range for {n} training points")
        return _shrink_one(_own(rstream.evict(_one(state), i % n,
                                              k=hp["k"])))

    def pvalues(state, ctx, X_test, hp):
        if hp["t_query"] is None:
            raise ValueError(
                "knn_regression p-values need a label grid: pass "
                "t_query=<array> (or use .intervals(X_test, eps))")
        t_query = _tensor(hp["t_query"], torch.float32, X_test.device)
        return rsession.pvalues(_one(state), X_test[None], t_query,
                                k=hp["k"])[0]

    def intervals(state, ctx, X_test, epsilon, hp):
        return rsession.intervals(_one(state), X_test[None], k=hp["k"],
                                  epsilon=float(epsilon))[0]

    return MeasureSpec("knn_regression", fit, observe, evict, pvalues,
                       defaults={"k": 7, "t_query": None},
                       intervals=intervals)


register(_knn_spec("knn", simplified=False))
register(_knn_spec("simplified_knn", simplified=True))
register(_kde_spec())
register(_lssvm_spec())
register(_knn_regression_spec())
register(_bootstrap_spec())


# ---------------------------------------------------------------------------
# unified predictor
# ---------------------------------------------------------------------------


class ConformalPredictor:
    """Stateful full-CP predictor over any registered measure."""

    def __init__(self, measure: str = "simplified_knn", device=None,
                 **hyperparams):
        self.spec = get(measure)
        unknown = set(hyperparams) - set(self.spec.defaults)
        if unknown:
            raise TypeError(
                f"{measure}: unknown hyperparameters {sorted(unknown)}; "
                f"accepts {sorted(self.spec.defaults)}")
        self.hp = {**self.spec.defaults, **hyperparams}
        self.device = resolve(device)
        self._state = None
        self._ctx = None

    def fit(self, X, y) -> "ConformalPredictor":
        self._state, self._ctx = self.spec.fit(
            _tensor(X, torch.float32, self.device),
            torch.as_tensor(y, device=self.device), self.hp)
        return self

    def observe(self, x, y) -> "ConformalPredictor":
        """Learn one example (paper's incremental update)."""
        self._state = self.spec.observe(
            self._state, self._ctx, _tensor(x, torch.float32, self.device),
            y, self.hp)
        return self

    def evict(self, i: int = 0) -> "ConformalPredictor":
        """Forget training point ``i`` (paper's decremental update)."""
        if self.spec.evict is None:
            raise NotImplementedError(
                f"measure {self.spec.name!r} has no decremental update")
        self._state = self.spec.evict(self._state, self._ctx, i, self.hp)
        return self

    def pvalues(self, X_test) -> torch.Tensor:
        return self.spec.pvalues(self._state, self._ctx,
                                 _tensor(X_test, torch.float32, self.device),
                                 self.hp)

    def predict_set(self, X_test, eps: float) -> torch.Tensor:
        return pv.prediction_sets(self.pvalues(X_test), eps)

    def intervals(self, X_test, eps: float) -> torch.Tensor:
        """Prediction intervals (m, 2) — regression measures only."""
        if self.spec.intervals is None:
            raise NotImplementedError(
                f"measure {self.spec.name!r} has no interval read path "
                "(classification measures predict sets; see predict_set)")
        return self.spec.intervals(
            self._state, self._ctx,
            _tensor(X_test, torch.float32, self.device), eps, self.hp)

    @property
    def n(self) -> int:
        """Current training-set size (leading dim of the state's first
        leaf)."""
        return int(self._state.leaves()[0].shape[0])


__all__ = ["MeasureSpec", "ConformalPredictor", "register", "get",
           "available"]
