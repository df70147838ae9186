"""Online CP core: the incremental simplified-k-NN state, ring-slot
arithmetic, the shared decremental list repair, and the betting
martingale. Counterpart of ``repro/core/online.py``.

Every function works on a leading tenant axis ``S``: ``X (S, cap, p)``,
``y (S, cap)``, ``best (S, cap, k)``, per-tenant scalars ``(S,)`` int32.
Where the JAX package vmaps a per-tenant function, the port writes the
batch axis out; a single stream is ``S == 1``. Float sums run in fixed
order (``fsum``), so a tenant's bits do not depend on ``S``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch._device import BIG, resolve
from repro_torch.kernels import ops as kops


def fsum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right, one rounding per add."""
    acc = a[..., 0]
    for j in range(1, a.shape[-1]):
        acc = acc + a[..., j]
    return acc


# ---------------------------------------------------------------------------
# ring-buffer slot arithmetic (see repro/core/online.py for the layout)
# ---------------------------------------------------------------------------


def ring_age(cap: int, head: torch.Tensor, wrap) -> torch.Tensor:
    """``(S, cap)`` arrival age of each slot (0 = oldest) of a ring at
    ``head`` with modulus ``wrap``; slots ``>= wrap`` get the sentinel age
    ``cap`` (never live)."""
    idx = torch.arange(cap, dtype=torch.int32, device=head.device)
    h = head[..., None]
    m = torch.as_tensor(wrap, dtype=torch.int32, device=head.device)[..., None]
    raw = torch.where(idx >= h, idx - h, idx - h + m)
    return torch.where(idx < m, raw, cap)


def ring_live(cap: int, head, n, wrap) -> torch.Tensor:
    """``(S, cap)`` live mask of a ring holding ``n`` points at ``head``."""
    return ring_age(cap, head, wrap) < n[..., None]


def ring_slots(cap: int, head, wrap) -> torch.Tensor:
    """``(S, cap)`` slot of each arrival rank, ``(head + i) % wrap``."""
    s = torch.arange(cap, dtype=torch.int32, device=head.device) + head[..., None]
    m = torch.as_tensor(wrap, dtype=torch.int32, device=head.device)[..., None]
    return torch.where(s >= m, s - m, s)


def ring_mod(v, m):
    """``v % m`` for ``v`` already in ``[0, 2 m)``."""
    return torch.where(v >= m, v - m, v)


def next_aid(aid, head, n, wrap) -> torch.Tensor:
    """Arrival id for the next insert: one past the newest live slot's (0
    for an empty window). int32 wraparound is allowed (see the JAX
    counterpart)."""
    newest = ring_mod(head + n - 1 + wrap * (n == 0).to(n.dtype), wrap)
    last = aid.gather(-1, newest.long()[..., None])[..., 0]
    return torch.where(n > 0, last + 1, torch.zeros_like(last))


def drop_backfill_core(L, es, cand, Ds, *, k):
    """Decremental list repair of one evicted point (batched form of
    ``repro.core.online.drop_backfill_core``): drop the first slot of each
    ascending list ``L (S, w, k)`` holding the evicted distance ``es``,
    then backfill the new k-th best by multiset rank over the stored
    distances ``Ds (S, w, w)`` masked by ``cand``. Every output is a
    selected stored value. Both reductions are order-free (an integer
    count and a min), so they equal JAX's variadic reduce bit for bit.
    Returns ``(newL, pos0, cols, b, tprime, mprime)``."""
    pos0 = (L < es[..., None]).sum(-1, dtype=torch.int32)
    Lup = torch.cat([L[..., 1:], torch.full_like(L[..., :1], BIG)], -1)
    if k >= 2:
        tprime = torch.where(pos0 <= k - 2, L[..., k - 1], L[..., k - 2])
    else:
        tprime = torch.full_like(es, -1.0)
    mprime = ((L == tprime[..., None]).sum(-1, dtype=torch.int32)
              - (es == tprime).to(torch.int32))
    t = tprime[..., None]
    cnt = (cand & (Ds == t)).sum(-1, dtype=torch.int32)
    gtmin = torch.where(cand & (Ds > t), Ds, BIG).amin(-1)
    b = torch.where(cnt > mprime, tprime, gtmin)
    cols = torch.arange(k, device=L.device)
    p0 = pos0[..., None]
    newL = torch.where(cols < p0, L,
                       torch.where(cols < k - 1, Lup, b[..., None]))
    return newL, pos0, cols, b, tprime, mprime


def drop_backfill(L, es, cand, Ds, aff, *, k, Ly=None, La=None, ys=None,
                  aid=None, age=None, slots=None, aid0=None):
    """Batched ``repro.core.online.drop_backfill``: repair the rows
    flagged in ``aff (S, w)``; other rows pass through bitwise untouched.
    Classification (``Ly is None``) repairs the distance lists and
    returns ``newL``.

    The labeled form (regression) also repairs the neighbour-label lists
    ``Ly`` and arrival-id lists ``La (S, w, k)`` and returns ``(newL,
    newLy, newLa)``. The backfill label follows fit's ties-toward-the-
    earliest-arrival order: among the candidate columns at the backfill
    distance ``b``, it comes from the earliest arrival above the largest
    id the list already holds at ``b``. Ids are compared as int32
    wraparound differences from ``aid0 (S,)``, the evicted (globally
    earliest) live id, so the raw counters may overflow. The pick is a
    masked min over arrival rank ``age (S, w)`` and one gather through
    the rank -> slot permutation ``slots (S, w)``; ``ys (S, w)`` and
    ``aid (S, w)`` are the per-slot labels and ids.
    """
    newL, pos0, cols, b, tprime, _ = drop_backfill_core(L, es, cand, Ds,
                                                        k=k)
    a = aff[..., None]
    if Ly is None:
        return torch.where(a, newL, L)
    w = L.shape[-2]
    rel_La = La - aid0[:, None, None]  # int32 wrap-subtract
    thr = torch.where(
        b == tprime,
        torch.where(L == tprime[..., None], rel_La, -1).amax(-1), -1)
    rel_aid = (aid - aid0[:, None])[:, None, :]
    valid = Ds == b[..., None]  # (S, w, w), narrowed in place
    valid &= cand
    valid &= rel_aid > thr[..., None]
    amin = torch.where(valid, age[:, None, :], w).amin(-1)
    del valid
    sel = slots.gather(1, amin.clamp(max=w - 1).long()).long()
    yb, ab = ys.gather(1, sel), aid.gather(1, sel)  # b >= BIG: fixed below
    p0 = pos0[..., None]
    Lyup = torch.cat([Ly[..., 1:], Ly[..., :1]], -1)
    newLy = torch.where(cols < p0, Ly,
                        torch.where(cols < k - 1, Lyup, yb[..., None]))
    Laup = torch.cat([La[..., 1:], La[..., :1]], -1)
    newLa = torch.where(cols < p0, La,
                        torch.where(cols < k - 1, Laup, ab[..., None]))
    # missing-neighbour slots carry the row's own label (fit convention)
    # and the neutral arrival id 0
    big = newL >= BIG
    newLy = torch.where(big, ys[..., None], newLy)
    newLa = torch.where(big, 0, newLa)
    return (torch.where(a, newL, L), torch.where(a, newLy, Ly),
            torch.where(a, newLa, La))


# ---------------------------------------------------------------------------
# the incremental state
# ---------------------------------------------------------------------------


@dataclass
class OnlineKnnState:
    """Capacity-padded incremental simplified-k-NN CP state, batched over
    tenants. Rows outside the live window are inert (distances BIG,
    scores never counted); ``best`` holds each live point's k best
    same-label distances, ascending, BIG-padded."""

    X: torch.Tensor  # (S, cap, p)
    y: torch.Tensor  # (S, cap) int32, -1 on never-written rows
    best: torch.Tensor  # (S, cap, k)
    n: torch.Tensor  # (S,) int32 live count


def init(capacity: int, p: int, k: int, *, n_sessions: int = 1,
         dtype=torch.float32, device=None) -> OnlineKnnState:
    dev = resolve(device)
    S = n_sessions
    return OnlineKnnState(
        X=torch.zeros((S, capacity, p), dtype=dtype, device=dev),
        y=torch.full((S, capacity), -1, dtype=torch.int32, device=dev),
        best=torch.full((S, capacity, k), BIG, dtype=dtype, device=dev),
        n=torch.zeros((S,), dtype=torch.int32, device=dev),
    )


def _observe_impl(state: OnlineKnnState, x_new, y_new, tau, *, k,
                  head=None, wrap=None):
    """Price ``(x_new, y_new)`` against the window, and compute what
    learning it writes — without writing it.

    Returns ``(p, d, merged, idx)``: the smoothed p-values ``(S,)``, the
    live-masked distance rows ``(S, cap)``, every row's new k-best list
    ``(S, cap, k)`` with the new point's own list already at its slot,
    and that slot ``idx (S,)``. ``head=None`` is the linear layout (the
    new point lands at slot ``n``); otherwise at ``(head + n) % wrap``.
    """
    X, y, best, n = state.X, state.y, state.best, state.n
    cap = X.shape[1]
    if head is None:  # linear layout: n < cap, the new point at slot n
        head, wrap = torch.zeros_like(n), cap
    live = ring_live(cap, head, n, wrap)
    idx = ring_mod(head + n, wrap)
    d, merged, _ = kops.stream_update(X, y, best, None, x_new, y_new, n,
                                      mode="class", head=head, wrap=wrap)
    same = (y == y_new[:, None]) & live
    cand = torch.where(same, d, BIG)
    own = -torch.topk(-cand, k, dim=-1).values  # ascending k best
    alpha = fsum(own)

    # provisional -> updated scores (cancellation-safe base + (kth or d))
    base = fsum(best[..., :-1])
    kth = best[..., -1]
    upd = same & (d < kth)
    alphas = base + torch.where(upd, d, kth)
    gt = (live & (alphas > alpha[:, None])).sum(-1)
    eq = (live & (alphas == alpha[:, None])).sum(-1)
    p = ((gt + tau * (eq + 1.0)) / (n + 1.0)).to(X.dtype)

    ar = torch.arange(X.shape[0], device=X.device)
    merged[ar, idx.long()] = own
    return p, d, merged, idx


def observe_with_dists(state: OnlineKnnState, x_new, y_new, tau, *, k,
                       head=None, wrap=None):
    """One online step for every tenant: smoothed p-value, then learn.

    Updates ``state`` in place (the new row of ``X``/``y``, the lists, the
    count) and returns ``(state, p (S,), d (S, cap))`` — ``d`` is the
    live-masked distance row that a caller keeping pairwise distances
    reuses."""
    p, d, merged, idx = _observe_impl(state, x_new, y_new, tau, k=k,
                                      head=head, wrap=wrap)
    ar = torch.arange(state.X.shape[0], device=state.X.device)
    state.X[ar, idx.long()] = x_new.to(state.X.dtype)
    state.y[ar, idx.long()] = y_new.to(state.y.dtype)
    state.best = merged
    state.n = state.n + 1
    return state, p, d


def observe(state: OnlineKnnState, x_new, y_new, tau, *, k):
    """``observe_with_dists`` without the distance row."""
    state, p, _ = observe_with_dists(state, x_new, y_new, tau, k=k)
    return state, p


# ---------------------------------------------------------------------------
# betting martingale over the p-value stream
# ---------------------------------------------------------------------------


def simple_mixture_log_martingale(pvals: torch.Tensor) -> torch.Tensor:
    """Log of the simple-mixture martingale over the last axis: the power
    martingale mixed over a 19-point grid of epsilon. ``pvals (..., T)``
    -> ``log M_n`` for every prefix ``(..., T)``."""
    pvals = torch.as_tensor(pvals)
    eps = torch.linspace(0.05, 0.95, 19, dtype=pvals.dtype,
                         device=pvals.device)
    logp = torch.log(torch.clamp(pvals, min=1e-12))
    logf = torch.log(eps)[:, None] + (eps[:, None] - 1.0) * logp[..., None, :]
    logM = torch.cumsum(logf, dim=-1)  # (..., eps, T)
    return torch.logsumexp(logM, dim=-2) - math.log(len(eps))


def run_stream(X, y, *, k, taus=None, generator=None, capacity=None,
               device=None):
    """Feed one full stream ``X (T, p)``, ``y (T,)`` through the online
    state; returns ``(p-values (T,), log mixture martingale (T,))``.
    ``taus (T,)`` are the tie-breaking uniforms; without them they are
    drawn from ``generator``."""
    dev = resolve(device)
    X = torch.as_tensor(X, device=dev)
    y = torch.as_tensor(y, dtype=torch.int32, device=dev)
    T, p_dim = X.shape
    if taus is None:
        gdev = "cpu" if generator is None else generator.device
        taus = torch.rand((T,), generator=generator, dtype=X.dtype,
                          device=gdev)
    taus = torch.as_tensor(taus, dtype=X.dtype).to(dev)
    state = init(capacity or T, p_dim, k, dtype=X.dtype, device=dev)
    pvals = []
    for t in range(T):
        state, pv = observe(state, X[t][None], y[t][None], taus[t][None],
                            k=k)
        pvals.append(pv[0])
    pvals = torch.stack(pvals)
    return pvals, simple_mixture_log_martingale(pvals)


__all__ = ["OnlineKnnState", "init", "observe", "observe_with_dists",
           "run_stream", "simple_mixture_log_martingale", "ring_age",
           "ring_live", "ring_slots", "ring_mod", "next_aid",
           "drop_backfill", "drop_backfill_core", "fsum", "BIG"]
