"""Micro-batching multi-tenant online CP engine, counterpart of
``repro/serving/engine.py``.

All tenants' sessions live in one batched ``Session`` (leading axis =
tenant slot) and every tick advances them together: one launch of each
kernel for the whole batch. Per-tenant p-values are bit-identical to
running that tenant's stream alone through ``core.online.run_stream``
(tested); sliding-window eviction is the exact decremental update of
``serving.session``.

Usage::

    eng = ServingEngine(n_sessions=64, capacity=256, dim=16, k=7,
                        window=128)             # device defaults to cuda
    state = eng.init_state()
    g = torch.Generator(device=eng.device).manual_seed(0)
    state, p = eng.observe(state, x_t, y_t, eng.taus(g))   # (64,)
    state, ps = eng.observe_many(state, xs, ys, taus)      # (T, 64)
    pv = eng.predict(state, x_query)                       # (64, m, L)

``observe``/``observe_many`` update the state's tensors in place (the
torch form of the JAX engine's donation) and return it; ``donate=False``
clones the state first and leaves the caller's untouched. Tenants with no
traffic on a tick are masked by ``active`` (state bitwise unchanged, NaN
p-value). Without a ``window`` the engine grows: once a chunk could
overflow, every tenant's capacity doubles.

``instrument=True`` attaches ``telemetry.EngineTelemetry`` under the JAX
engine's metric names: each observe / observe_many / grow / predict is
timed and traced, and a chunk's tick counters (evictions, ring wraps,
occupancy) accumulate on the device until ``engine.telemetry.drain()``.
An instrumented engine is bitwise the plain one.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import distributed as dist
from repro_torch.core import engine_utils
from repro_torch.serving import session as sess_m
from repro_torch.serving.session import Session
from repro_torch.telemetry.hooks import EngineTelemetry


class ServingEngine:
    """Fixed-slot multi-tenant CP serving engine.

    n_sessions: tenant slots (the micro-batch width); capacity: padded
    per-tenant rows; dim: features; k: neighbourhood size; n_labels:
    label alphabet of ``predict``; window: sliding window (<= capacity),
    None for grow mode; dtype: state float type (float32 on CUDA);
    donate: update the caller's state in place (False: clone first);
    layout: "ring" (default) — circular row indexing: a sliding tick
    evicts by advancing each tenant's head, so the ``(cap, cap)``
    distance matrices are never shifted or copied; "compact" — the
    historic positional layout, whose eviction compacts every leaf
    (O(cap^2) bytes a tick): the ring's bit-oracle and its baseline,
    bit-identical to "ring";
    instrument: attach telemetry (module doc); metrics: the
    ``MetricsRegistry`` it publishes into (default: the process-wide
    one); tracer: an optional ``Tracer``, one record an operation;
    sync_timing: synchronise inside each timed operation, so the times
    are device-true instead of enqueue times (off on the serving path);
    device: where the state lives, ``cuda`` by default (raises without a
    GPU; ``"cpu"`` runs the plain PyTorch path);
    shards: split the tenant axis across this many devices
    (``core.distributed``): the state is a ``TenantSharded``, each tick
    runs every shard's unmodified step on its own device and moves no
    byte between shards, bitwise the one-device engine (tested). Needs
    ``n_sessions % shards == 0`` (pad with inactive lanes:
    ``distributed.pad_tenant_count``) and that many visible cards of
    ``device``'s kind unless ``devices`` names them;
    devices: the shards' devices in order (may repeat one device: logical
    shards, as the CPU tests and the one-card smoke run them).
    """

    def __init__(self, *, n_sessions: int, capacity: int, dim: int, k: int,
                 n_labels: int = 2, window: int | None = None,
                 dtype=torch.float32, donate: bool = True,
                 layout: str = "ring", instrument: bool = False,
                 metrics=None, tracer=None, sync_timing: bool = False,
                 device=None, shards: int = 1, devices=None):
        if window is not None and window > capacity:
            raise ValueError(f"window {window} exceeds capacity {capacity}")
        if window is not None and window < 1:
            raise ValueError("window must be >= 1")
        if capacity < k:
            raise ValueError(f"capacity {capacity} < k {k}")
        if layout not in ("ring", "compact"):
            raise ValueError(f"unknown layout {layout!r}")
        if shards > 1 and n_sessions % shards != 0:
            raise ValueError(
                f"n_sessions {n_sessions} not divisible by shards "
                f"{shards}; pad with inactive lanes "
                "(core.distributed.pad_tenant_count)")
        self.shards = shards
        self.mesh, self.device = engine_utils.placement(shards, device,
                                                         devices)
        self.n_sessions = n_sessions
        self.capacity = capacity
        self.dim = dim
        self.k = k
        self.n_labels = n_labels
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
                engine="classification", metrics=metrics, tracer=tracer,
                sync=sync_timing, n_of=lambda s: s.knn.n,
                head_of=lambda s: s.head, wrap_of=lambda s: s.wrap)
            if self.mesh is not None:
                self.telemetry.devices = self.mesh.flat()

    # -- state --------------------------------------------------------------

    def init_state(self) -> Session:
        """Empty batched sessions; sliding engines confine each ring to
        the ``[:window]`` block (``wrap == window``). With ``shards > 1``
        a ``TenantSharded`` state, each shard built on its device."""
        return engine_utils.init_state(self, lambda S, dev: sess_m.init(
            self.capacity, self.dim, self.k, n_sessions=S, dtype=self.dtype,
            wrap=self._wmax, device=dev))

    def shard_state(self, state):
        """``state`` laid out as this engine serves it: split across its
        tenant mesh, or gathered onto its one device (a restore, a state
        of another engine)."""
        return engine_utils.shard_state(self, state)

    def taus(self, generator: torch.Generator | None = None) -> torch.Tensor:
        """One tie-breaking uniform per tenant slot for this tick."""
        gdev = self.device if generator is None else generator.device
        return torch.rand((self.n_sessions,), generator=generator,
                          dtype=self.dtype, device=gdev).to(self.device)

    # -- serving ------------------------------------------------------------

    def _cast(self, xs, ys, taus, active):
        dev = self.device
        xs = torch.as_tensor(xs, dtype=self.dtype, device=dev)
        ys = torch.as_tensor(ys, device=dev).to(torch.int32)
        taus = torch.as_tensor(taus, device=dev).to(self.dtype)
        if active is None:
            active = torch.ones(ys.shape, dtype=torch.bool, device=dev)
        active = torch.as_tensor(active, dtype=torch.bool, device=dev)
        return xs, ys, taus, active

    def observe(self, state: Session, x, y, tau, active=None):
        """One tick: learn ``(x[s], y[s])`` in every active slot. Returns
        ``(state, p (S,))`` — the T=1 case of ``observe_many``."""
        x, y, tau, active = self._cast(x, y, tau, active)
        state, p = engine_utils.dispatch(self, state, x[None], y[None],
                                         tau[None], active[None],
                                         op="observe")
        return state, p[0]

    def observe_many(self, state: Session, xs, ys, taus, active=None):
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

    def grow(self, state: Session, factor: int = 2) -> Session:
        """Multiply every tenant's capacity (a new state). A sliding
        engine pins the ring modulus back to its window block."""
        with engine_utils.timed(self, "grow", tenants=self.n_sessions,
                                capacity=self.capacity * factor,
                                signature=self.capacity):
            out = engine_utils.grow(self, state, factor, sess_m.grow)
        self.capacity = out.capacity
        if self._wmax is not None:
            for part in dist.parts_of(out):
                part.wrap = torch.full_like(part.wrap, self._wmax)
        return out

    def predict(self, state: Session, X_test) -> torch.Tensor:
        """Read-only full-CP p-values ``(S, m, n_labels)``. ``X_test`` is
        ``(S, m, dim)`` per tenant or ``(m, dim)`` shared by all."""
        X_test = torch.as_tensor(X_test, dtype=self.dtype,
                                 device=self.device)
        if X_test.dim() == 2:
            X_test = X_test.contiguous().expand(
                (self.n_sessions,) + tuple(X_test.shape))
        with engine_utils.timed(self, "predict",
                                signature=(tuple(X_test.shape),
                                           self.capacity),
                                tenants=self.n_sessions,
                                capacity=self.capacity) as tm:
            return tm.sync(engine_utils.read(
                self, lambda st, xq: sess_m.predict_pvalues(
                    st, xq, k=self.k, n_labels=self.n_labels),
                state, X_test))

    # -- snapshot metadata --------------------------------------------------

    def meta(self) -> dict[str, Any]:
        """JSON-serializable engine config (the JAX engine's keys)."""
        return {
            "n_sessions": self.n_sessions,
            "capacity": self.capacity,
            "dim": self.dim,
            "k": self.k,
            "n_labels": self.n_labels,
            "window": self.window,
            "dtype": str(self.dtype).removeprefix("torch."),
            "shards": self.shards,
        }

    @classmethod
    def from_meta(cls, meta: dict[str, Any], device=None,
                  devices=None) -> "ServingEngine":
        """The engine of a snapshot's meta. Its ``shards`` is kept where
        that many devices exist (``devices``, else the visible ones of
        ``device``'s kind) and ``n_sessions`` divides, else the engine
        serves on one device, as the reference's does (bitwise the
        same)."""
        meta = dict(meta)
        meta["dtype"] = getattr(torch, meta.get("dtype", "float32"))
        place = engine_utils.meta_shards(meta, device, devices)
        return cls(**meta, **place)


__all__ = ["ServingEngine"]
