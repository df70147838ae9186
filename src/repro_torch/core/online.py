"""Online CP core: the incremental simplified-k-NN state, ring-slot
arithmetic, the shared decremental list repair, and the betting
martingale. Counterpart of ``repro/core/online.py``. The repair
(``drop_backfill``) and the ring ages and slots it takes live in
``kernels/ref.py``, beside the plain version of the fused serving tick
that calls them, and are re-exported here.

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
import torch.nn.functional as F

from repro_torch._device import BIG, resolve
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import (drop_backfill, drop_backfill_core, fsum,
                                     ring_age, ring_slots)


# ---------------------------------------------------------------------------
# ring-buffer slot arithmetic (see repro/core/online.py for the layout)
# ---------------------------------------------------------------------------


def ring_live(cap: int, head, n, wrap) -> torch.Tensor:
    """``(S, cap)`` live mask of a ring holding ``n`` points at ``head``."""
    return ring_age(cap, head, wrap) < n[..., None]


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


def cshift(a: torch.Tensor, s: torch.Tensor, fill) -> torch.Tensor:
    """Conditionally drop each tenant's leading row: ``a (S, cap, ...)``
    shifted up by one where ``s (S,)`` is 1, ``fill`` entering at the
    tail; a new tensor, bitwise ``a`` where ``s`` is 0. The compaction
    primitive of the compact layout's sliding tick."""
    shifted = torch.cat([a[:, 1:], torch.full_like(a[:, :1], fill)], 1)
    return torch.where((s != 0).view((-1,) + (1,) * (a.dim() - 1)),
                       shifted, a)


def cshift2(D: torch.Tensor, s: torch.Tensor, fill) -> torch.Tensor:
    """``cshift`` of a square ``D (S, cap, cap)`` along both of its axes:
    its first row and column dropped where ``s`` is 1."""
    shifted = F.pad(D[:, 1:, 1:], (0, 1, 0, 1), value=fill)
    return torch.where((s != 0)[:, None, None], shifted, D)


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
                  head=None, wrap=None, D=None, ev=None):
    """Price ``(x_new, y_new)`` against the window, and compute what
    learning it writes — without writing it.

    Returns ``(p, d, merged, idx)``: the smoothed p-values ``(S,)``, the
    live-masked distance rows ``(S, cap)``, every row's new k-best list
    ``(S, cap, k)`` with the new point's own list already at its slot,
    and that slot ``idx (S,)``. ``head=None`` is the linear layout (the
    new point lands at slot ``n``); otherwise at ``(head + n) % wrap``.
    With ``ev (S,)`` (a sliding tick) the window ``(head, n)`` is the one
    after the eviction of slot ``head - 1`` by the tenants with ``ev``
    set, and the same launch first repairs ``state.best`` for it in
    place, from the distances ``D (S, cap, cap)`` (``drop_backfill``'s
    bits, over the rows that held the evicted point only).
    """
    X, y, best, n = state.X, state.y, state.best, state.n
    cap = X.shape[1]
    if head is None:  # linear layout: n < cap, the new point at slot n
        head, wrap = torch.zeros_like(n), cap
    live = ring_live(cap, head, n, wrap)
    idx = ring_mod(head + n, wrap)
    d, merged, _, _, base = kops.stream_tick(
        X, y, best, None, x_new, y_new, n, mode="class", head=head,
        wrap=wrap, D=D, ev=ev)
    same = (y == y_new[:, None]) & live
    cand = torch.where(same, d, BIG)
    own = -torch.topk(-cand, k, dim=-1).values  # ascending k best
    alpha = fsum(own)

    # provisional -> updated scores (cancellation-safe base + (kth or d));
    # base = fsum(best[..., :-1]) comes from the same launch
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
# betting martingales over the p-value stream
# ---------------------------------------------------------------------------


def power_martingale_increment(p, epsilon=0.92):
    """Power betting function ``f(p) = eps * p^(eps - 1)`` (its integral
    over [0, 1] is 1)."""
    p = torch.as_tensor(p)
    return epsilon * torch.pow(torch.clamp(p, min=1e-12), epsilon - 1.0)


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
           "run_stream", "power_martingale_increment",
           "simple_mixture_log_martingale", "ring_age", "ring_live",
           "ring_slots", "ring_mod", "next_aid", "cshift", "cshift2",
           "drop_backfill", "drop_backfill_core", "fsum", "BIG"]
