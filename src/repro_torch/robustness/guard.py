"""Guarded engine tick: input admission and poison-lane quarantine,
counterpart of ``repro/robustness/guard.py``.

One NaN feature admitted into a tenant's lane contaminates that lane's
distance matrix and every later p-value. ``TickGuard`` wraps a serving
engine with two defences, both outside the engine's tick:

admission (on the device, per chunk)
    Elementwise checks of the observe inputs (features finite; label in
    ``[0, n_labels)`` for classification, finite for regression; tau in
    ``[0, 1]``) fold rejections into the chunk's ``active`` mask, so a
    rejected observe never happens for that lane-tick: the state stays
    bitwise unchanged and the p-value is NaN (the engines' ``active``
    contract). Rejections add into a device-side ``(3,)`` accumulator in
    ``REJECT_KINDS`` order, published as
    ``guard_rejected_inputs_total{kind}`` by ``drain()``.

poison detection and quarantine (per sweep)
    Corruption that admission cannot see shows as non-finite values in a
    lane's cheap float leaves (``X`` and ``best``, or ``X``, ``y`` and
    ``nbr_d``; not the ``(S, cap, cap)`` distances, whose poison can only
    come through those). Every ``check_every`` chunks the detector is
    launched after the chunk and its ``(S,)`` flags are fetched one sweep
    later: the guard's only host synchronisation, by which time the
    flags' work has long finished behind the next chunk. Non-finite
    poison in those leaves is sticky, so the lag loses nothing;
    ``finalize(state)`` flushes the last pending check. A tripped lane
    is frozen (masked out of every later tick: ``quarantined_lanes``,
    ``guard_quarantines_total``), then restored in place from the last
    committed snapshot of an attached ``SessionStore``
    (``guard_restores_total``), followed by ``engine.reset_occupancy()``;
    with no usable snapshot it stays frozen.

On clean traffic the guard is bit-neutral: the effective mask is the
caller's and the engine sees the same inputs.
"""
from __future__ import annotations

import torch

from repro_torch.core import distributed as dist
from repro_torch.regression.session import repad as repad_reg
from repro_torch.serving.session import repad as repad_cls

#: rejection-kind order in the device-side accumulator
REJECT_KINDS = ("nonfinite_feature", "label_out_of_range",
                "tau_out_of_range")


class TickGuard:
    """``engine`` (a ``ServingEngine`` or ``RegressionServingEngine``) with
    admission and quarantine; a drop-in for its observe path::

        guard = TickGuard(engine, store=session_store, metrics=reg)
        state, p = guard.observe_many(state, xs, ys, taus)

    Reads (``predict``, ``intervals``, ``pvalues``, ``meta``, ...) pass
    through to the engine.

    store: optional ``serving.snapshot.SessionStore`` holding committed
    snapshots of this engine's state, the lane-restore source (``None``:
    tripped lanes stay frozen); metrics: optional ``MetricsRegistry``;
    check_every: sweep for poison every this many guarded chunks.
    """

    def __init__(self, engine, *, store=None, metrics=None,
                 check_every: int = 2):
        self.engine = engine
        self.store = store
        self.metrics = metrics
        self.check_every = max(int(check_every), 1)
        self._classification = hasattr(engine, "n_labels")
        dev = engine.device
        self._qmask = torch.zeros(engine.n_sessions, dtype=torch.bool,
                                  device=dev)
        self.quarantined: set = set()
        self._racc = torch.zeros(len(REJECT_KINDS), dtype=torch.int64,
                                 device=dev)
        self._chunks = 0
        self._pending = None  # (S,) poison flags on the device
        self._quarantines = 0
        self._restores = 0
        self._cache_step = None
        self._cache_state = None

    # -- observe path -------------------------------------------------------

    def _admit(self, xs, ys, taus, active):
        ok_x = torch.isfinite(xs).all(-1)
        if self._classification:
            ok_y = (ys >= 0) & (ys < self.engine.n_labels)
        else:
            ok_y = torch.isfinite(ys)
        ok_tau = torch.isfinite(taus) & (taus >= 0.0) & (taus <= 1.0)
        live = active & ~self._qmask
        eff = live & ok_x & ok_y & ok_tau
        self._racc += torch.stack([
            (live & ~ok_x).sum(),
            (live & ok_x & ~ok_y).sum(),
            (live & ok_x & ok_y & ~ok_tau).sum()])
        return eff

    def _poison(self, state) -> torch.Tensor:
        """``(S,)`` lanes with a non-finite feature or label, or a NaN
        list distance (BIG, not inf, pads the lists)."""
        def nonfinite(t):
            return (~torch.isfinite(t)).flatten(1).any(1)

        def nan(t):
            return torch.isnan(t).flatten(1).any(1)

        def flags(st):
            if self._classification:
                return nonfinite(st.knn.X) | nan(st.knn.best)
            return nonfinite(st.X) | nonfinite(st.y) | nan(st.nbr_d)

        return torch.cat([flags(part).to(self.engine.device)
                          for part in dist.parts_of(state)])

    def observe(self, state, x, y, tau, active=None):
        """Guarded one-tick ``observe``; the engine's contract."""
        x, y, tau, active = self.engine._cast(x, y, tau, active)
        state, p = self.observe_many(state, x[None], y[None], tau[None],
                                     active[None])
        return state, p[0]

    def observe_many(self, state, xs, ys, taus, active=None):
        """Guarded chunk: ``engine.observe_many`` on the admitted
        lane-ticks, then the poison sweep every ``check_every`` chunks."""
        xs, ys, taus, active = self.engine._cast(xs, ys, taus, active)
        eff = self._admit(xs, ys, taus, active)
        state, p = self.engine.observe_many(state, xs, ys, taus, eff)
        self._chunks += 1
        if self._chunks % self.check_every == 0:
            state = self._sweep(state)  # consumes the previous flags
            self._pending = self._poison(state)  # fetched next sweep
        return state, p

    def finalize(self, state):
        """Flush the deferred poison check at the end of a stream (the
        last chunk's flags are still pending). Returns the state, lanes
        restored where they could be; call before ``drain()``."""
        state = self._sweep(state)
        self._pending = self._poison(state)
        return self._sweep(state)

    # -- quarantine ---------------------------------------------------------

    def _sweep(self, state):
        """Consume the pending flags: freeze the newly tripped lanes, then
        try to restore them. The flags read an earlier version of the
        state; poison in the checked leaves is sticky, so a lane flagged
        then is poisoned now."""
        if self._pending is None:
            return state
        bad = self._pending.tolist()
        self._pending = None
        hit = [i for i, b in enumerate(bad)
               if b and i not in self.quarantined]
        if not hit:
            return state
        for lane in hit:
            self.quarantined.add(lane)
            self._quarantines += 1
            if self.metrics is not None:
                self.metrics.counter("guard_quarantines_total").inc()
        self._sync_qmask()
        for lane in hit:
            state = self._restore_lane(state, lane)
        return state

    def _sync_qmask(self):
        q = torch.zeros(self.engine.n_sessions, dtype=torch.bool)
        q[sorted(self.quarantined)] = True
        self._qmask = q.to(self.engine.device)
        if self.metrics is not None:
            self.metrics.gauge("quarantined_lanes").set(
                len(self.quarantined))

    def _snapshot_state(self):
        """The last committed snapshot on the host (cached per step)."""
        if self.store is None:
            return None
        step = self.store.latest_step()
        if step is None:
            return None
        if step != self._cache_step:
            snap, _, _ = self.store.restore(device="cpu")  # walks back
            self._cache_step = step
            self._cache_state = snap
        return self._cache_state

    def _restore_lane(self, state, lane: int):
        """Copy the snapshot's lane into ``state`` in place (repadded to
        the current capacity in grow mode, as the fleet migrates). With
        no snapshot, another lane grid, a shrinking capacity, a sliding
        window's capacity change or a snapshot that is itself poisoned,
        the lane stays frozen."""
        snap = self._snapshot_state()
        if snap is None:
            return state
        eng = self.engine
        if snap.D.shape[0] != eng.n_sessions:
            return state
        lane_state = type(snap).from_leaves(
            [leaf[lane:lane + 1] for leaf in snap.leaves()])
        snap_cap, cur_cap = lane_state.capacity, state.capacity
        if snap_cap != cur_cap:
            if eng._wmax is not None or snap_cap > cur_cap:
                return state
            repad = repad_cls if self._classification else repad_reg
            lane_state = repad(lane_state, cur_cap)
        if not all(bool(torch.isfinite(v).all())
                   for v in lane_state.leaves() if v.is_floating_point()):
            return state
        part, i = ((state, lane) if not isinstance(state, dist.TenantSharded)
                   else state.locate(lane))
        for dst, src in zip(part.leaves(), lane_state.leaves()):
            dst[i].copy_(src[0])
        eng.reset_occupancy()
        self.quarantined.discard(lane)
        self._restores += 1
        if self.metrics is not None:
            self.metrics.counter("guard_restores_total").inc()
        self._sync_qmask()
        return state

    # -- reporting ----------------------------------------------------------

    def drain(self) -> dict:
        """Sync and publish the guard's counters, and reset them. Returns
        ``{rejected: {kind: n}, quarantines, restores,
        quarantined_lanes}``."""
        rej = [int(v) for v in self._racc.tolist()]
        self._racc.zero_()
        if self.metrics is not None:
            for kind, n in zip(REJECT_KINDS, rej):
                if n:
                    self.metrics.counter("guard_rejected_inputs_total",
                                         kind=kind).inc(n)
        out = {
            "rejected": dict(zip(REJECT_KINDS, rej)),
            "quarantines": self._quarantines,
            "restores": self._restores,
            "quarantined_lanes": sorted(self.quarantined),
        }
        self._quarantines = 0
        self._restores = 0
        return out

    def __getattr__(self, name):
        return getattr(self.engine, name)


__all__ = ["TickGuard", "REJECT_KINDS"]
