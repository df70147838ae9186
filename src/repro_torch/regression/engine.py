"""Micro-batching multi-tenant streaming regression-CP engine, counterpart
of ``repro/regression/engine.py``.

Every tenant's ``RegStreamState`` lives in one batched state (leading
axis = tenant slot); each tick advances all of them with one launch of
the reg-mode ``stream_update`` kernel, and ``intervals`` serves every
tenant's prediction intervals with one launch of the pairwise and the
``interval_sweep`` kernels.

Usage::

    eng = RegressionServingEngine(n_sessions=64, capacity=256, dim=16,
                                  k=7, window=128)  # device defaults to cuda
    state = eng.init_state()
    state, p = eng.observe(state, x_t, y_t, tau_t)         # (64,)
    state, ps = eng.observe_many(state, xs, ys, taus)      # (T, 64)
    iv = eng.intervals(state, x_query, epsilon=0.1)        # (64, m, 2)

``observe``/``observe_many`` update the state's tensors in place and
return it; ``donate=False`` clones the state first. Tenants with no
traffic on a tick are masked by ``active`` (state bitwise unchanged, NaN
p-value). Without a ``window`` the engine grows: once a chunk could
overflow, every tenant's capacity doubles.

``instrument=True`` attaches ``telemetry.EngineTelemetry`` as on the
classification engine (``engine="regression"``; ``intervals`` and
``pvalues`` are the timed reads). An instrumented engine is bitwise the
plain one.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch._device import resolve
from repro_torch.core import engine_utils
from repro_torch.regression import session as sess_m
from repro_torch.regression.stream import RegStreamState
from repro_torch.telemetry.hooks import EngineTelemetry


class RegressionServingEngine:
    """Fixed-slot multi-tenant regression-CP serving engine.

    n_sessions: tenant slots; capacity: padded per-tenant rows; dim:
    features; k: neighbourhood size; window: sliding window (<=
    capacity), None for grow mode; dtype: state float type (float32 on
    CUDA); donate: update the caller's state in place (False: clone
    first); layout: "ring" (default) — circular row indexing, eviction a
    head advance that never shifts or copies the ``(cap, cap)`` distance
    matrices; "compact" — the historic positional layout, whose eviction
    compacts every leaf (O(cap^2) bytes a tick): the ring's bit-oracle
    and its baseline, bit-identical to "ring"; instrument, metrics,
    tracer, sync_timing: telemetry, as on ``serving.ServingEngine``;
    device: ``cuda`` by default (raises without a GPU; ``"cpu"`` runs
    the plain PyTorch path).
    """

    def __init__(self, *, n_sessions: int, capacity: int, dim: int, k: int,
                 window: int | None = None, dtype=torch.float32,
                 donate: bool = True, layout: str = "ring",
                 instrument: bool = False, metrics=None, tracer=None,
                 sync_timing: bool = False, device=None):
        if window is not None and window > capacity:
            raise ValueError(f"window {window} exceeds capacity {capacity}")
        if window is not None and window < 1:
            raise ValueError("window must be >= 1")
        if capacity < k:
            raise ValueError(f"capacity {capacity} < k {k}")
        if layout not in ("ring", "compact"):
            raise ValueError(f"unknown layout {layout!r}")
        self.device = resolve(device)
        self.n_sessions = n_sessions
        self.capacity = capacity
        self.dim = dim
        self.k = k
        self.window = window
        self.dtype = dtype
        self.donate = donate
        self.layout = layout
        self._step = (sess_m._sliding_step if layout == "ring"
                      else sess_m._sliding_step_compact)
        # a sliding window bounds occupancy: the tick runs on the
        # [:window] block of every leaf with ring modulus == window
        self._wmax = None if window is None else max(min(window, capacity),
                                                     k)
        self._w_checked = False
        self._n_bound: int | None = None
        self.telemetry = None
        if instrument:
            self.telemetry = EngineTelemetry(
                engine="regression", metrics=metrics, tracer=tracer,
                sync=sync_timing, n_of=lambda s: s.n,
                head_of=lambda s: s.head, wrap_of=lambda s: s.wrap)

    # -- state --------------------------------------------------------------

    def init_state(self) -> RegStreamState:
        """Empty batched states; sliding engines confine each ring to the
        ``[:window]`` block (``wrap == window``)."""
        return sess_m.init(self.capacity, self.dim, self.k,
                           n_sessions=self.n_sessions, dtype=self.dtype,
                           wrap=self._wmax, device=self.device)

    # -- serving ------------------------------------------------------------

    def _cast(self, xs, ys, taus, active):
        dev, dt = self.device, self.dtype
        xs = torch.as_tensor(xs, dtype=dt, device=dev)
        ys = torch.as_tensor(ys, dtype=dt, device=dev)
        taus = torch.as_tensor(taus, dtype=dt, device=dev)
        if active is None:
            active = torch.ones(ys.shape, dtype=torch.bool, device=dev)
        active = torch.as_tensor(active, dtype=torch.bool, device=dev)
        return xs, ys, taus, active

    def observe(self, state: RegStreamState, x, y, tau, active=None):
        """One tick: learn ``(x[s], y[s])`` in every active slot. Returns
        ``(state, p (S,))`` — the T=1 case of ``observe_many``."""
        x, y, tau, active = self._cast(x, y, tau, active)
        state, p = engine_utils.dispatch(self, state, x[None], y[None],
                                         tau[None], active[None],
                                         op="observe")
        return state, p[0]

    def observe_many(self, state: RegStreamState, xs, ys, taus,
                     active=None):
        """T ticks: ``xs (T, S, dim)``, ``ys, taus (T, S)``, ``active
        (T, S)`` bool (default all). Returns ``(state, p (T, S))``; row t
        equals what the t-th of T ``observe`` calls returns. In grow mode
        the whole chunk's occupancy is provisioned first."""
        xs, ys, taus, active = self._cast(xs, ys, taus, active)
        return engine_utils.dispatch(self, state, xs, ys, taus, active,
                                     op="observe_many")

    def reset_occupancy(self) -> None:
        """Forget the grow-mode occupancy bound and the window-invariant
        check, so the next ``observe`` reads and checks them again. Call
        after substituting a state this engine did not produce (a
        restore, a lane repair)."""
        self._n_bound = None
        self._w_checked = False

    def grow(self, state: RegStreamState, factor: int = 2) -> RegStreamState:
        """Multiply every tenant's capacity (a new state). A sliding
        engine pins the ring modulus back to its window block."""
        with engine_utils.timed(self, "grow", tenants=self.n_sessions,
                                capacity=self.capacity * factor,
                                signature=self.capacity):
            out = sess_m.grow(state, factor)
        self.capacity = out.capacity
        if self._wmax is not None:
            out.wrap = torch.full_like(out.wrap, self._wmax)
        return out

    def _queries(self, X_test) -> torch.Tensor:
        X_test = torch.as_tensor(X_test, dtype=self.dtype,
                                 device=self.device)
        if X_test.dim() == 2:
            X_test = X_test.contiguous().expand(
                (self.n_sessions,) + tuple(X_test.shape))
        return X_test

    def intervals(self, state: RegStreamState, X_test,
                  epsilon: float) -> torch.Tensor:
        """Prediction intervals ``(S, m, 2)``; ``X_test`` is ``(S, m,
        dim)`` per tenant or ``(m, dim)`` shared by all."""
        X_test = self._queries(X_test)
        with self._timed_read("intervals", X_test) as tm:
            return tm.sync(sess_m.intervals(state, X_test, k=self.k,
                                            epsilon=epsilon))

    def pvalues(self, state: RegStreamState, X_test,
                t_query) -> torch.Tensor:
        """P-values at the query labels ``t_query (nq,)``: ``(S, m,
        nq)``."""
        t_query = torch.as_tensor(t_query, dtype=self.dtype,
                                  device=self.device)
        X_test = self._queries(X_test)
        with self._timed_read("pvalues", X_test) as tm:
            return tm.sync(sess_m.pvalues(state, X_test, t_query, k=self.k))

    def _timed_read(self, op: str, X_test):
        return engine_utils.timed(
            self, op, signature=(tuple(X_test.shape), self.capacity),
            tenants=self.n_sessions, capacity=self.capacity)

    # -- snapshot metadata --------------------------------------------------

    def meta(self) -> dict[str, Any]:
        """JSON-serializable engine config (the JAX engine's keys)."""
        return {
            "mode": "regression",
            "n_sessions": self.n_sessions,
            "capacity": self.capacity,
            "dim": self.dim,
            "k": self.k,
            "window": self.window,
            "dtype": str(self.dtype).removeprefix("torch."),
        }

    @classmethod
    def from_meta(cls, meta: dict[str, Any],
                  device=None) -> "RegressionServingEngine":
        meta = dict(meta)
        mode = meta.pop("mode", "regression")
        if mode != "regression":
            raise ValueError(f"not a regression-engine meta: mode={mode!r}")
        meta.pop("n_labels", None)  # classification-era keys
        meta.pop("shards", None)  # the JAX engine's tenant sharding
        meta["dtype"] = getattr(torch, meta.get("dtype", "float32"))
        return cls(**meta, device=device)


__all__ = ["RegressionServingEngine"]
