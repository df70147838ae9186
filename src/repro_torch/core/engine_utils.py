"""Host-side bookkeeping of the serving engines, counterpart of
``repro/core/engine_utils.py``: grow-mode capacity provisioning, the
sliding-window occupancy invariant and the shared observe body with its
telemetry, for any state with ``n``, ``wrap`` and ``capacity``
(classification ``Session`` and regression ``RegStreamState``). (The JAX
``scan_chunk`` becomes ``dispatch``'s plain Python loop over ticks.)

A tenant-sharded engine (``eng.mesh`` set, its state a
``core.distributed.TenantSharded``) runs each of these per shard: the
ticks through ``distributed.shard_tenant_chunk``, the occupancy bound and
the window check over every shard's lanes, a grow on every shard."""
from __future__ import annotations

import contextlib

import torch

from repro_torch._device import resolve
from repro_torch.core import distributed as dist


class _Untimed:
    """The handle ``timed`` yields for an engine without telemetry."""

    @staticmethod
    def sync(value):
        return value


@contextlib.contextmanager
def timed(eng, op: str, **fields):
    """``eng.telemetry.timed(op, **fields)``, or nothing to time when the
    engine is not instrumented."""
    if eng.telemetry is None:
        yield _Untimed
        return
    with eng.telemetry.timed(op, **fields) as tm:
        yield tm


def placement(shards: int, device, devices):
    """``(mesh or None, first device)`` of an engine built with ``shards``
    and ``devices``: one shard is the plain single-device path (on
    ``devices[0]`` when a list is given); more need that many devices,
    the visible cards of ``device``'s kind unless ``devices`` names
    them."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if shards == 1:
        return None, resolve(devices[0] if devices else device)
    mesh = dist.tenant_mesh(shards, dist.visible_devices(device)
                            if devices is None else devices)
    return mesh, mesh.flat()[0]


def meta_shards(meta: dict, device, devices) -> dict:
    """The engine keyword arguments of a snapshot's ``shards``: kept where
    that many devices (``devices``, else the visible ones) exist and the
    tenant count divides, else one device (the reference's fallback;
    the results are bitwise the same either way)."""
    shards = int(meta.pop("shards", 1))
    avail = (dist.visible_devices(device) if devices is None
             else list(devices))
    if (shards > 1 and shards <= len(avail)
            and meta["n_sessions"] % shards == 0):
        return {"shards": shards, "devices": avail[:shards]}
    return {"device": avail[0] if devices is not None else device}


def init_state(eng, init):
    """``init(n_sessions, device)`` for the whole engine, or a shard at a
    time on its device (each lane starts the same)."""
    if eng.mesh is None:
        return init(eng.n_sessions, eng.device)
    per = eng.n_sessions // eng.shards
    return dist.TenantSharded([init(per, dev) for dev in eng.mesh.flat()],
                              eng.mesh)


def shard_state(eng, state):
    """``state`` laid out as ``eng`` serves it: split across its mesh (a
    state sharded another way is gathered first), or gathered onto its
    device."""
    if eng.mesh is None:
        return dist.gather_tenants(state, eng.device)
    if isinstance(state, dist.TenantSharded):
        if state.mesh.flat() == eng.mesh.flat():
            return state
        state = dist.gather_tenants(state)
    return dist.put_tenant_sharded(state, eng.mesh)


def grow(eng, state, factor: int, grow_fn):
    """``grow_fn(part, factor)`` on every shard of ``state``."""
    if isinstance(state, dist.TenantSharded):
        return dist.TenantSharded([grow_fn(p, factor) for p in state.parts],
                                  state.mesh)
    return grow_fn(state, factor)


def read(eng, fn, state, *args):
    """A read ``fn(state, X_test, *rest)`` on every shard (``X_test``
    split along its tenant axis, the rest copied), concatenated on the
    first device."""
    if eng.mesh is None:
        return fn(state, *args)
    return dist.shard_tenant_fn(fn, eng.mesh,
                                (True, True) + (False,) * (len(args) - 1))(
        state, *args)


def dispatch(eng, state, xs, ys, taus, active, *, op: str):
    """The observe / observe_many body shared by both engines: ``T``
    ticks of ``eng._step`` over ``xs (T, S, dim)`` and the rest, after
    the grow-mode provisioning and the occupancy check. Returns ``(state,
    p (T, S))``. An instrumented engine times the ticks under ``op`` and
    records the chunk for its tick stats before the first tick, because
    the ticks update ``n`` and ``head`` in place (a shard at a time when
    the engine is tenant-sharded)."""
    if not eng.donate:
        state = state.clone()
    state = ensure_room(eng, state, xs.shape[0])
    check_window_occupancy(eng, state)
    window = state.capacity + 1 if eng.window is None else eng.window
    T, S = xs.shape[:2]

    def step(part, x, y, tau, act):
        return eng._step(part, x, y, tau, window, act, k=eng.k,
                         evictable=eng.window is not None, wmax=eng._wmax)

    if eng.telemetry is not None:
        if eng.mesh is None:
            eng.telemetry.record_chunk(state, window, active)
        else:
            for i, part in enumerate(state.parts):
                lo, hi = state.cuts[i], state.cuts[i + 1]
                eng.telemetry.record_chunk(
                    part, window, active[:, lo:hi].to(eng.mesh.flat()[i]),
                    shard=i)
    with timed(eng, op, signature=(tuple(xs.shape), eng.capacity), ticks=T,
               tenants=S, capacity=eng.capacity) as tm:
        if eng.mesh is not None:
            state, p = dist.shard_tenant_chunk(step, eng.mesh)(
                state, xs, ys, taus, active)
        else:
            ps = []
            for t in range(T):
                state, pt = step(state, xs[t], ys[t], taus[t], active[t])
                ps.append(pt)
            p = torch.stack(ps)
        p = tm.sync(p)
    return state, p


def ensure_room(eng, state, ticks: int):
    """Grow-mode capacity check for the next ``ticks`` ticks.

    n grows by at most 1 per tick, so a host counter upper-bounds
    occupancy; the true max is read from the device only at startup and
    when the bound would cross capacity. Mutates ``eng._n_bound``; returns
    the (possibly grown) state."""
    if eng.window is not None:
        return state
    cap = state.capacity
    if eng._n_bound is None or eng._n_bound + ticks > cap:
        eng._n_bound = max(int(p.n.max()) for p in dist.parts_of(state))
        while eng._n_bound + ticks > cap:
            state = eng.grow(state)
            cap = state.capacity
    eng._n_bound += ticks
    return state


def check_window_occupancy(eng, state) -> None:
    """One-time ring/occupancy invariant check for an externally supplied
    state: a sliding engine needs every occupancy <= its window block and
    every ring modulus == that block; a grow engine needs the modulus ==
    the capacity."""
    if eng._w_checked:
        return
    parts = dist.parts_of(state)
    lo = min(int(p.wrap.min()) for p in parts)
    hi = max(int(p.wrap.max()) for p in parts)
    if eng.window is None:
        if lo != state.capacity or hi != state.capacity:
            raise ValueError(
                f"state ring modulus {lo}..{hi} does not match this "
                f"grow-mode engine's capacity {state.capacity}; normalize "
                "it first (session.to_linear / grow)")
        eng._w_checked = True
        return
    nmax = max(int(p.n.max()) for p in parts)
    if nmax > eng._wmax:
        raise ValueError(
            f"state occupancy {nmax} exceeds the sliding window "
            f"{eng.window}: evict down to the window before serving")
    if lo != eng._wmax or hi != eng._wmax:
        raise ValueError(
            f"state ring modulus {lo}..{hi} does not match this engine's "
            f"window block {eng._wmax}; normalize it first")
    eng._w_checked = True


__all__ = ["check_window_occupancy", "dispatch", "ensure_room", "grow",
           "init_state", "meta_shards", "placement", "read", "shard_state",
           "timed"]
