"""Tenant lifecycle over capacity-bucketed engine pools, counterpart of
``repro/serving/fleet.py``.

An engine serves a fixed grid of lanes at one capacity, and in grow mode
one tenant filling its lane doubles every lane of the engine. The fleet
groups tenants into pools by capacity bucket and moves a tenant to the
next bucket's pool as it grows: one lane repad instead of a pool-wide
grow. Bucket bounds come from a fitted cost model
(``CostModel.suggest_buckets``) when one is given, else the power-of-two
ladder. Each pool is an ordinary grow-mode ``ServingEngine`` /
``RegressionServingEngine``, so a fleet-served tenant's p-values are
bitwise those of a dedicated one-lane engine fed the same stream:
p-values do not depend on capacity padding, and a migration is the
sessions' ``repad`` to the target capacity (the ring normalised to
linear order, every leaf padded with its inert fill; ``grow`` is
``repad`` to a multiple).

    fleet = Fleet(dim=8, k=5, n_labels=2)      # device defaults to cuda
    fleet.admit("alice"); fleet.admit("bob")
    ps = fleet.observe({"alice": (x_a, y_a, tau_a),
                        "bob": (x_b, y_b, tau_b)})
    pv = fleet.predict("alice", X_query)       # (m, n_labels)
    fleet.retire("bob")                        # the lane returns to its pool

Tenants past the last bucket stay in the last pool, whose engine grows as
before. ``shards=N`` tenant-shards every pool engine across N devices
(``core.distributed``; ``devices=`` names them, else N visible cards):
``pool_sessions`` rounds up to a multiple of N, a lane write lands on
its shard's device, and the served p-values are bitwise those of the
one-device fleet (tested).
"""
from __future__ import annotations

import bisect
from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.core import distributed as dist
from repro_torch.regression import stream as reg_stream
from repro_torch.regression.engine import RegressionServingEngine
from repro_torch.regression.session import repad as repad_reg
from repro_torch.serving import session as cls_sess_m
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.session import repad as repad_cls


def pow2_buckets(cap_min: int, cap_max: int) -> list[int]:
    """The power-of-two bucket ladder (the fallback without a cost model,
    and what ``suggest_buckets`` gives under linear cost scaling)."""
    bounds = [int(cap_min)]
    while bounds[-1] < cap_max:
        bounds.append(min(bounds[-1] * 2, int(cap_max)))
    return bounds


class _Pool:
    """One engine, its state and its lanes' bookkeeping at one capacity."""

    def __init__(self, fleet: "Fleet", capacity: int, index: int):
        self.capacity = capacity
        self.index = index
        self.engine = fleet._make_engine(capacity)
        self.state = self.engine.init_state()
        S = self.engine.n_sessions
        self.free: list[int] = list(range(S - 1, -1, -1))
        self.lane_tenant: dict[int, Any] = {}

    def _locate(self, lane: int):
        """``(state or shard, lane in it)`` of pool lane ``lane``."""
        if isinstance(self.state, dist.TenantSharded):
            return self.state.locate(lane)
        return self.state, lane

    def set_lane(self, lane: int, lane_state) -> None:
        """Copy a one-lane state into lane ``lane``, in place (onto its
        shard's device)."""
        part, i = self._locate(lane)
        for dst, src in zip(part.leaves(), lane_state.leaves()):
            dst[i].copy_(src[0])
        self.engine.reset_occupancy()

    def get_lane(self, lane: int):
        """Lane ``lane`` as a one-lane state (views of the pool's)."""
        part, i = self._locate(lane)
        return type(part).from_leaves(
            [leaf[i:i + 1] for leaf in part.leaves()])


class Fleet:
    """Admit, observe and retire tenants across bucketed engine pools.

    dim, k, n_labels, dtype: each tenant's CP geometry (``n_labels`` only
    in classification mode); mode: "classification" or "regression";
    every pool runs grow mode. cost_model: a fitted
    ``telemetry.costmodel.CostModel`` whose ``suggest_buckets`` gives the
    bucket bounds (``None``: powers of two); cap_min, cap_max: the
    bucket range, ``cap_min`` every new tenant's capacity (>= k);
    cost_ratio: each bucket's top-to-bottom modelled cost; pool_sessions:
    lanes per pool engine, rounded up to a multiple of ``shards`` (a
    full pool spills into a sibling); shards, devices: tenant-shard every
    pool engine (``ServingEngine``'s); metrics: optional
    ``MetricsRegistry``; guard: check observe inputs on the host (finite
    features, label in range, tau in [0, 1]); a rejected tenant's tick
    is not run, its state stays bitwise unchanged and its p-value is NaN
    (``fleet_rejected_observes_total``); device: ``cuda`` by default.
    """

    def __init__(self, *, dim: int, k: int, n_labels: int = 2,
                 mode: str = "classification", cost_model=None,
                 cap_min: int = 32, cap_max: int = 4096,
                 cost_ratio: float = 2.0, pool_sessions: int = 64,
                 dtype=torch.float32, shards: int = 1, devices=None,
                 metrics=None, guard: bool = False, device=None):
        if mode not in ("classification", "regression"):
            raise ValueError(f"unknown fleet mode {mode!r}")
        if cap_min < k:
            raise ValueError(f"cap_min {cap_min} < k {k}")
        self.shards = shards
        self.devices = devices
        self.device = resolve(devices[0] if devices else device)
        self.dim = dim
        self.k = k
        self.n_labels = n_labels
        self.mode = mode
        self.dtype = dtype
        self.pool_sessions = -(-pool_sessions // shards) * shards
        self.metrics = metrics
        self.guard = guard
        if cost_model is not None:
            self.buckets = cost_model.suggest_buckets(
                cap_min=cap_min, cap_max=cap_max, cost_ratio=cost_ratio,
                engine=mode)
        else:
            self.buckets = pow2_buckets(cap_min, cap_max)
        self._pools: dict[int, list[_Pool]] = {}
        self._where: dict[Any, tuple[int, int, int]] = {}  # cap, pool, lane
        self._occ: dict[Any, int] = {}
        self._init_lane_cache: dict[int, Any] = {}

    # -- engine and pool plumbing -------------------------------------------

    def _make_engine(self, capacity: int):
        kw = dict(n_sessions=self.pool_sessions, capacity=capacity,
                  dim=self.dim, k=self.k, window=None, dtype=self.dtype,
                  device=self.device, shards=self.shards,
                  devices=self.devices)
        if self.mode == "classification":
            return ServingEngine(n_labels=self.n_labels, **kw)
        return RegressionServingEngine(**kw)

    def _init_lane(self, capacity: int):
        lane = self._init_lane_cache.get(capacity)
        if lane is None:
            m = cls_sess_m if self.mode == "classification" else reg_stream
            lane = m.init(capacity, self.dim, self.k, dtype=self.dtype,
                          device=self.device)
            self._init_lane_cache[capacity] = lane
        return lane

    def _alloc(self, capacity: int) -> tuple[_Pool, int]:
        pools = self._pools.setdefault(capacity, [])
        for pool in pools:
            if pool.free:
                return pool, pool.free.pop()
        pool = _Pool(self, capacity, len(pools))
        pools.append(pool)
        if self.metrics is not None:
            self.metrics.gauge("fleet_pools", mode=self.mode).set(
                sum(len(ps) for ps in self._pools.values()))
        return pool, pool.free.pop()

    def _counter(self, name: str):
        if self.metrics is not None:
            self.metrics.counter(name, mode=self.mode).inc()

    def _set_tenants_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("fleet_tenants", mode=self.mode).set(
                len(self._where))

    # -- lifecycle ----------------------------------------------------------

    def admit(self, tid) -> None:
        """Give ``tid`` a fresh lane in the smallest-capacity pool (free
        lanes are always reset, so this is host bookkeeping)."""
        if tid in self._where:
            raise KeyError(f"tenant {tid!r} already admitted")
        cap = self.buckets[0]
        pool, lane = self._alloc(cap)
        pool.lane_tenant[lane] = tid
        self._where[tid] = (cap, pool.index, lane)
        self._occ[tid] = 0
        self._counter("fleet_admissions_total")
        self._set_tenants_gauge()

    def retire(self, tid) -> None:
        """Return ``tid``'s lane to its pool, reset at once: a stale full
        lane would count toward the pool's grow-mode occupancy bound."""
        cap, pi, lane = self._where.pop(tid)
        pool = self._pools[cap][pi]
        del pool.lane_tenant[lane]
        del self._occ[tid]
        # the engine's capacity: the last pool may have grown past its bound
        pool.set_lane(lane, self._init_lane(pool.engine.capacity))
        pool.free.append(lane)
        self._counter("fleet_retirements_total")
        self._set_tenants_gauge()

    def _migrate(self, tid, needed: int) -> None:
        """Move ``tid`` to the smallest bucket that holds ``needed``
        points: one lane repad instead of a pool-wide grow."""
        src_cap, spi, slane = self._where[tid]
        i = bisect.bisect_left(self.buckets, needed)
        new_cap = self.buckets[min(i, len(self.buckets) - 1)]
        if new_cap <= src_cap:
            return
        src_pool = self._pools[src_cap][spi]
        repad = (repad_cls if self.mode == "classification"
                 else repad_reg)
        lane_state = repad(src_pool.get_lane(slane), new_cap)
        del src_pool.lane_tenant[slane]
        src_pool.set_lane(slane, self._init_lane(src_pool.engine.capacity))
        src_pool.free.append(slane)
        pool, lane = self._alloc(new_cap)
        pool.set_lane(lane, lane_state)
        pool.lane_tenant[lane] = tid
        self._where[tid] = (new_cap, pool.index, lane)
        self._counter("fleet_migrations_total")

    # -- serving ------------------------------------------------------------

    def _admissible(self, x, y, tau) -> bool:
        ok = bool(np.all(np.isfinite(np.asarray(x, dtype=np.float64))))
        yf = float(np.asarray(y).astype(np.float64))
        if self.mode == "classification":
            ok = ok and np.isfinite(yf) and 0 <= int(yf) < self.n_labels
        else:
            ok = ok and bool(np.isfinite(yf))
        tau_f = float(tau)
        return ok and bool(np.isfinite(tau_f)) and 0.0 <= tau_f <= 1.0

    def observe(self, items: dict[Any, tuple]) -> dict[Any, torch.Tensor]:
        """One fleet tick: ``items`` maps tid -> ``(x, y, tau)`` (host
        values). Tenants about to outgrow their pool migrate first; then
        each pool with traffic runs one engine tick, its other lanes
        inactive. Returns tid -> p-value (a 0-d tensor on the device, not
        yet synchronised). With ``guard=True`` a malformed item gets a NaN
        p-value and leaves its tenant's state and occupancy unchanged."""
        out: dict[Any, torch.Tensor] = {}
        if self.guard:
            live = {}
            for tid, item in items.items():
                if self._admissible(*item):
                    live[tid] = item
                else:
                    self._counter("fleet_rejected_observes_total")
                    out[tid] = torch.full((), float("nan"),
                                          dtype=self.dtype,
                                          device=self.device)
            items = live
        out.update(self._observe_live(items))
        return out

    def _observe_live(self, items: dict[Any, tuple]
                      ) -> dict[Any, torch.Tensor]:
        last = self.buckets[-1]
        for tid in items:
            cap, _, _ = self._where[tid]
            if self._occ[tid] + 1 > cap and cap < last:
                self._migrate(tid, self._occ[tid] + 1)
        groups: dict[tuple[int, int], dict[int, tuple]] = {}
        for tid, (x, y, tau) in items.items():
            cap, pi, lane = self._where[tid]
            groups.setdefault((cap, pi), {})[lane] = (tid, x, y, tau)
        out: dict[Any, torch.Tensor] = {}
        np_dt = np.dtype(str(self.dtype).removeprefix("torch."))
        ydt = np.int32 if self.mode == "classification" else np_dt
        for (cap, pi), lanes in sorted(groups.items()):
            pool = self._pools[cap][pi]
            S = pool.engine.n_sessions
            xs = np.zeros((S, self.dim), dtype=np_dt)
            ys = np.zeros((S,), dtype=ydt)
            taus = np.zeros((S,), dtype=np_dt)
            act = np.zeros((S,), dtype=bool)
            for lane, (tid, x, y, tau) in lanes.items():
                xs[lane] = np.asarray(x)
                ys[lane] = y
                taus[lane] = tau
                act[lane] = True
            pool.state, p = pool.engine.observe(pool.state, xs, ys, taus,
                                                active=act)
            for lane, (tid, _, _, _) in lanes.items():
                out[tid] = p[lane]
                self._occ[tid] += 1
        return out

    def _lane_of(self, tid) -> tuple[_Pool, int]:
        cap, pi, lane = self._where[tid]
        return self._pools[cap][pi], lane

    def predict(self, tid, X_test) -> torch.Tensor:
        """Classification full-CP p-values ``(m, n_labels)`` of one
        tenant."""
        pool, lane = self._lane_of(tid)
        return pool.engine.predict(pool.state, X_test)[lane]

    def intervals(self, tid, X_test, epsilon: float) -> torch.Tensor:
        """Regression prediction intervals ``(m, 2)`` of one tenant."""
        pool, lane = self._lane_of(tid)
        return pool.engine.intervals(pool.state, X_test, epsilon)[lane]

    def pvalues(self, tid, X_test, t_query) -> torch.Tensor:
        """Regression p-values ``(m, nq)`` of one tenant."""
        pool, lane = self._lane_of(tid)
        return pool.engine.pvalues(pool.state, X_test, t_query)[lane]

    # -- introspection ------------------------------------------------------

    def occupancy(self, tid) -> int:
        """Host-tracked live-point count (exact in grow mode)."""
        return self._occ[tid]

    def stats(self) -> dict[str, Any]:
        """Host-side fleet snapshot; publishes the pools' lane gauges."""
        pools = []
        for cap in sorted(self._pools):
            for pool in self._pools[cap]:
                used = len(pool.lane_tenant)
                occ = [self._occ[t] for t in pool.lane_tenant.values()]
                pools.append({
                    "capacity": cap,
                    "pool": pool.index,
                    "lanes": pool.engine.n_sessions,
                    "lanes_used": used,
                    "occupancy_max": max(occ, default=0),
                    "occupancy_mean": (sum(occ) / used) if used else 0.0,
                })
                if self.metrics is not None:
                    self.metrics.gauge(
                        "fleet_pool_lanes_used", mode=self.mode,
                        capacity=cap, pool=pool.index).set(used)
        return {"tenants": len(self._where), "buckets": self.buckets,
                "pools": pools}


__all__ = ["Fleet", "pow2_buckets", "repad_cls", "repad_reg"]
