"""Host-side bookkeeping of the serving engines, counterpart of
``repro/core/engine_utils.py``: grow-mode capacity provisioning and the
sliding-window occupancy invariant, for any state with ``n``, ``wrap``
and ``capacity`` (classification ``Session`` and regression
``RegStreamState``). (The JAX ``scan_chunk`` becomes the engines' plain
Python loop over ticks.)"""
from __future__ import annotations


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


__all__ = ["ensure_room", "check_window_occupancy"]
