"""Host-side bookkeeping of the serving engines, counterpart of
``repro/core/engine_utils.py``: grow-mode capacity provisioning, the
sliding-window occupancy invariant and the shared observe body with its
telemetry, for any state with ``n``, ``wrap`` and ``capacity``
(classification ``Session`` and regression ``RegStreamState``). (The JAX
``scan_chunk`` becomes ``dispatch``'s plain Python loop over ticks.)"""
from __future__ import annotations

import contextlib

import torch


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


def dispatch(eng, state, xs, ys, taus, active, *, op: str):
    """The observe / observe_many body shared by both engines: ``T``
    ticks of ``eng._step`` over ``xs (T, S, dim)`` and the rest, after
    the grow-mode provisioning and the occupancy check. Returns ``(state,
    p (T, S))``. An instrumented engine times the ticks under ``op`` and
    records the chunk for its tick stats before the first tick, because
    the ticks update ``n`` and ``head`` in place."""
    if not eng.donate:
        state = state.clone()
    state = ensure_room(eng, state, xs.shape[0])
    check_window_occupancy(eng, state)
    window = state.capacity + 1 if eng.window is None else eng.window
    T, S = xs.shape[:2]
    if eng.telemetry is not None:
        eng.telemetry.record_chunk(state, window, active)
    with timed(eng, op, signature=(tuple(xs.shape), eng.capacity), ticks=T,
               tenants=S, capacity=eng.capacity) as tm:
        ps = []
        for t in range(T):
            state, p = eng._step(
                state, xs[t], ys[t], taus[t], window, active[t], k=eng.k,
                evictable=eng.window is not None, wmax=eng._wmax)
            ps.append(p)
        p = tm.sync(torch.stack(ps))
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
        eng._n_bound = int(state.n.max())
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
    lo, hi = int(state.wrap.min()), int(state.wrap.max())
    if eng.window is None:
        if lo != state.capacity or hi != state.capacity:
            raise ValueError(
                f"state ring modulus {lo}..{hi} does not match this "
                f"grow-mode engine's capacity {state.capacity}; normalize "
                "it first (session.to_linear / grow)")
        eng._w_checked = True
        return
    nmax = int(state.n.max())
    if nmax > eng._wmax:
        raise ValueError(
            f"state occupancy {nmax} exceeds the sliding window "
            f"{eng.window}: evict down to the window before serving")
    if lo != eng._wmax or hi != eng._wmax:
        raise ValueError(
            f"state ring modulus {lo}..{hi} does not match this engine's "
            f"window block {eng._wmax}; normalize it first")
    eng._w_checked = True


__all__ = ["dispatch", "timed", "ensure_room", "check_window_occupancy"]
