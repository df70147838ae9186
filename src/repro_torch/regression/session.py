"""Tenant-batched streaming regression-CP sessions. Counterpart of
``repro/regression/session.py``.

* ``_sliding_step`` — one tick for every tenant, in place: evict-if-full
  (a head advance and the labeled list repair), price the incoming point
  (smoothed online p-value of its observed label, feeding the drift
  martingales), learn it. ``D`` is read by the repair and written at one
  row and one column per tenant; no ``(cap, cap)`` buffer is copied.
  ``_sliding_step_compact`` keeps the historic linear layout (eviction
  compacts every leaf, ``D`` included): the ring tick's bit-oracle and
  its baseline (``layout="compact"`` on the engine).
* ``intervals`` / ``pvalues`` — the read paths on the arrival-ordered
  window: the pairwise kernel for the test rows' own top-k, the
  ``interval_sweep`` kernel for the critical points, then the hull
  sweep. One structure on every device: the kernels on the card, their
  plain versions on the CPU.

Read paths need ``n >= k``; earlier outputs are well-shaped but
degenerate, as in the batch path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch._device import BIG
from repro_torch.core.online import (cshift, cshift2, drop_backfill, fsum,
                                     next_aid, ring_live, ring_mod)
from repro_torch.core.regression import _threshold, hull_sweep, topk_lowest
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import div_k
from repro_torch.regression import stream
from repro_torch.regression.stream import RegStreamState

init = stream.init


def _price(d_row, y_sel, y_new, tau, *, k, live, nbr_d, nbr_y, ysum, y, n):
    """Smoothed online p-value ``(S,)`` of label ``y_new`` against the
    pre-learn window: ``alpha_i = |a_i + b_i y|``, ``alpha = |a + y|``
    with ``a`` from the new point's own selected labels ``y_sel (S, k)``,
    ties broken by ``tau``; ``ysum = fsum(nbr_y)``."""
    kth = nbr_d[..., -1]
    a_prime = y - div_k(ysum, k)
    enters = live & (d_row < kth)  # d_row is BIG off the live window
    a_vec = torch.where(enters, a_prime + div_k(nbr_y[..., -1], k), a_prime)
    b_vec = torch.where(enters, y.new_full((), -1.0 / k),
                        y.new_full((), 0.0))
    a = -div_k(fsum(y_sel), k)
    t = y_new.to(y.dtype)[:, None]
    alphas = (a_vec + b_vec * t).abs()
    alpha = (a[:, None] + t).abs()
    gt = (live & (alphas > alpha)).sum(-1)
    eq = (live & (alphas == alpha)).sum(-1)
    return ((gt + tau * (eq + 1.0)) / (n + 1.0)).to(y.dtype)


def _sliding_step(st: RegStreamState, x_new, y_new, tau, window, active, *,
                  k, evictable: bool = True, wmax: int | None = None):
    """One fused sliding-window tick for every tenant, in place:
    evict-if-full, price, learn, all gated by ``active (S,)``.

    Inactive lanes keep their state bitwise and return a NaN p-value.
    ``evictable=False`` drops the eviction (grow mode). ``wmax`` bounds
    occupancy: the ring then lives in the ``[:wmax]`` block of every leaf,
    whose views the kernels read in place. Returns ``(st, p (S,))``.
    """
    S, cap = st.y.shape
    w = cap if wmax is None or wmax >= cap else wmax
    Xw, yw, aidw = st.X[:, :w], st.y[:, :w], st.aid[:, :w]
    Dw = st.D[:, :w, :w]
    Lw, Lyw, Law = st.nbr_d[:, :w], st.nbr_y[:, :w], st.nbr_a[:, :w]
    head, n, wrap = st.head, st.n, st.wrap
    act = active
    ar = torch.arange(S, device=st.y.device)

    if evictable:
        ev = act & (n >= window)
        s = ev.to(torch.int32)
        head1 = ring_mod(head + s, wrap)
        n1 = n - s
    else:
        ev, head1, n1 = None, head, n
    live1 = ring_live(w, head1, n1, wrap)

    # one launch: the labeled repair of the lists that held the evicted
    # point (in place: Lw, Lyw, Law now hold them), then the distance row
    # and the merge into every live row's lists, ids included
    il = ring_mod(head1 + n1, wrap).long()
    y_new = y_new.to(yw.dtype)
    new_aid = next_aid(aidw, head1, n1, wrap)
    d_row, Lm, Lym, Lam, ysum = kops.stream_tick(
        Xw, yw, Lw, Lyw, x_new, y_new, n1, mode="reg", head=head1,
        wrap=wrap, D=Dw, ev=ev, aid=aidw, nbr_a=Law, new_aid=new_aid)
    sub = RegStreamState(Xw, yw, Dw, Lw, Lyw, n1, head1, aidw, wrap, Law)
    own_d, own_y, y_sel, own_a = stream._own_list(sub, d_row, y_new, k=k)
    p = _price(d_row, y_sel, y_new, tau, k=k, live=live1, nbr_d=Lw,
               nbr_y=Lyw, ysum=ysum, y=yw, n=n1)

    # gated in-place writes: one row and one column of D per tenant
    a1, a3 = act[:, None], act[:, None, None]
    row = torch.where(a1, d_row, Dw[ar, il, :])  # D is symmetric
    st.D[ar, il, :w] = row
    st.D[ar, :w, il] = row
    st.X[ar, il] = torch.where(a1, x_new.to(st.X.dtype), st.X[ar, il])
    st.y[ar, il] = torch.where(act, y_new, st.y[ar, il])
    st.aid[ar, il] = torch.where(act, new_aid, st.aid[ar, il])
    Lm[ar, il], Lym[ar, il], Lam[ar, il] = own_d, own_y, own_a
    st.nbr_d[:, :w] = torch.where(a3, Lm, Lw)
    st.nbr_y[:, :w] = torch.where(a3, Lym, Lyw)
    st.nbr_a[:, :w] = torch.where(a3, Lam, Law)
    st.n.copy_(torch.where(act, n1 + 1, n1))  # every leaf in place
    st.head.copy_(head1)
    return st, torch.where(act, p, torch.full_like(p, float("nan")))


def _sliding_step_compact(st: RegStreamState, x_new, y_new, tau, window,
                          active, *, k, evictable: bool = True,
                          wmax: int | None = None):
    """The historic linear-layout tick, the ring tick's bit-oracle: an
    evicting tenant compacts every leaf down one row (``D`` one row and
    one column, ``cshift``), the labeled plain ``drop_backfill`` repairs
    the lists over the compacted state (arrival rank == slot, ids
    compared from the evicted point's), then the reg-mode
    ``stream_update`` kernel without eviction computes the distance row
    and merges the lists, ids included. ``wmax`` runs the step on the
    ``[:wmax]`` block. Precondition: ``head == 0``, which the step keeps.
    Replaces ``st``'s leaves (the block's in place) and returns ``(st, p
    (S,))``."""
    S, cap = st.y.shape
    if wmax is not None and wmax < cap:
        sub = RegStreamState(
            st.X[:, :wmax], st.y[:, :wmax], st.D[:, :wmax, :wmax],
            st.nbr_d[:, :wmax], st.nbr_y[:, :wmax], st.n, st.head,
            st.aid[:, :wmax], st.wrap.clamp(max=wmax), st.nbr_a[:, :wmax])
        sub, p = _sliding_step_compact(sub, x_new, y_new, tau, window,
                                       active, k=k, evictable=evictable)
        for name in ("X", "y", "nbr_d", "nbr_y", "aid", "nbr_a"):
            getattr(st, name)[:, :wmax] = getattr(sub, name)
        st.D[:, :wmax, :wmax] = sub.D
        st.n = sub.n
        return st, p
    act = active
    dev = st.y.device
    ar = torch.arange(S, device=dev)
    ranks = torch.arange(cap, dtype=torch.int32, device=dev)
    if evictable:
        ev = act & (st.n >= window)
        s = ev.to(torch.int32)
        dcol = st.D[:, :, 0]
        affected = (ev[:, None] & (ranks < st.n[:, None])
                    & (dcol <= st.nbr_d[..., -1]))
        X1, y1, aid1 = (cshift(st.X, s, 0.0), cshift(st.y, s, 0.0),
                        cshift(st.aid, s, 0))
        D1 = cshift2(st.D, s, BIG)
        n1 = st.n - s
        lin = ranks.expand(S, cap)
        L1, Ly1, La1 = drop_backfill(
            cshift(st.nbr_d, s, BIG), cshift(dcol, s, BIG),
            (ranks < n1[:, None])[:, None, :], D1,
            cshift(affected, s, False), k=k, Ly=cshift(st.nbr_y, s, 0.0),
            La=cshift(st.nbr_a, s, 0), ys=y1, aid=aid1, age=lin, slots=lin,
            aid0=st.aid[:, 0])
    else:
        X1, y1, D1, aid1, n1 = st.X, st.y, st.D, st.aid, st.n
        L1, Ly1, La1 = st.nbr_d, st.nbr_y, st.nbr_a

    y_new = y_new.to(y1.dtype)
    zero, full = torch.zeros_like(n1), torch.full_like(n1, cap)
    new_aid = next_aid(aid1, zero, n1, full)
    d_row, Lm, Lym, Lam, ysum = kops.stream_tick(
        X1, y1, L1, Ly1, x_new, y_new, n1, mode="reg", nbr_a=La1,
        new_aid=new_aid)
    sub = RegStreamState(X1, y1, D1, L1, Ly1, n1, zero, aid1, full, La1)
    own_d, own_y, y_sel, own_a = stream._own_list(sub, d_row, y_new, k=k)
    p = _price(d_row, y_sel, y_new, tau, k=k, live=ranks < n1[:, None],
               nbr_d=L1, nbr_y=Ly1, ysum=ysum, y=y1, n=n1)

    # gated writes at slot n1; the clamp keeps an inactive lane of a full
    # window in bounds (it rewrites its own values there)
    il = n1.clamp(max=cap - 1).long()
    a1, a3 = act[:, None], act[:, None, None]
    row = torch.where(a1, d_row, D1[ar, il, :])  # D is symmetric
    D1[ar, il, :] = row
    D1[ar, :, il] = row
    X1[ar, il] = torch.where(a1, x_new.to(X1.dtype), X1[ar, il])
    y1[ar, il] = torch.where(act, y_new, y1[ar, il])
    aid1[ar, il] = torch.where(act, new_aid, aid1[ar, il])
    Lm[ar, il], Lym[ar, il], Lam[ar, il] = own_d, own_y, own_a
    st.nbr_d = torch.where(a3, Lm, L1)
    st.nbr_y = torch.where(a3, Lym, Ly1)
    st.nbr_a = torch.where(a3, Lam, La1)
    st.X, st.y, st.D, st.aid = X1, y1, D1, aid1
    st.n = torch.where(act, n1 + 1, n1)
    return st, torch.where(act, p, torch.full_like(p, float("nan")))


def _observe_sliding(st: RegStreamState, x_new, y_new, tau, window, *, k):
    """Evict-if-full then observe, every lane active: ``_sliding_step``
    with a per-tenant ``window``."""
    active = torch.ones_like(st.head, dtype=torch.bool)
    return _sliding_step(st, x_new, y_new, tau, window, active, k=k)


def _observe(st: RegStreamState, x_new, y_new, tau, *, k):
    """Price then learn one point per tenant (no eviction), in place.
    Precondition: ``n < wrap``."""
    active = torch.ones_like(st.head, dtype=torch.bool)
    return _sliding_step(st, x_new, y_new, tau, None, active, k=k,
                         evictable=False)


def grow(st: RegStreamState, factor: int = 2) -> RegStreamState:
    """Multiply every tenant's capacity by ``factor`` (a new state),
    normalizing the ring to linear order first."""
    return repad(st, st.capacity * factor)


def repad(st: RegStreamState, new_cap: int) -> RegStreamState:
    """Every tenant's capacity raised to ``new_cap`` (a new state): the
    ring normalised to linear order, every leaf padded with its inert
    fill. The fleet migrates a lane with it."""
    extra = new_cap - st.capacity
    s = stream.to_linear(st)
    return RegStreamState(
        X=F.pad(s.X, (0, 0, 0, extra)),
        y=F.pad(s.y, (0, extra)),
        D=F.pad(s.D, (0, extra, 0, extra), value=BIG),
        nbr_d=F.pad(s.nbr_d, (0, 0, 0, extra), value=BIG),
        nbr_y=F.pad(s.nbr_y, (0, 0, 0, extra)),
        n=s.n, head=s.head,
        aid=F.pad(s.aid, (0, extra)),
        wrap=torch.full_like(s.wrap, new_cap),
        nbr_a=F.pad(s.nbr_a, (0, 0, 0, extra)),
    )


def _test_score(yg, live, X_test, Xg, *, k):
    """Each test row's own score offset ``a = -(1/k) sum of its k
    nearest live labels``, ties to the earliest arrival: ``(S, m)``."""
    d = torch.sqrt(torch.clamp(kops.sq_dists(X_test, Xg), min=0.0))
    dm = torch.where(live[:, None, :], d, BIG)
    _, idx = topk_lowest(dm, k)  # (S, m, k)
    y_sel = yg.gather(1, idx.flatten(1)).view(idx.shape)
    return d, -div_k(fsum(y_sel), k)


def intervals(st: RegStreamState, X_test, *, k, epsilon):
    """Prediction intervals ``(S, m, 2)`` at miscoverage ``epsilon`` for
    the query rows ``X_test (S, m, p)``; NaN where the set is empty."""
    Xg, yg, a_prime, _, kth, kth_label, live = stream.arrival_stats(st, k=k)
    _, a_test = _test_score(yg, live, X_test, Xg, k=k)
    lo, hi = kops.interval_sweep(Xg, a_prime, kth, kth_label, live, X_test,
                                 a_test.contiguous(), k)
    thresh = _threshold(epsilon, st.n, Xg)
    return torch.stack(hull_sweep(lo, hi, lo > hi, thresh[:, None]), -1)


def pvalues(st: RegStreamState, X_test, t_query, *, k):
    """Exact p-values ``(S, m, nq)`` at the query labels ``t_query
    (nq,)``."""
    Xg, yg, a_prime, upd, kth, _, live = stream.arrival_stats(st, k=k)
    d, a = _test_score(yg, live, X_test, Xg, k=k)
    enters = live[:, None, :] & (d < kth[:, None, :])
    a_vec = torch.where(enters, upd[:, None, :], a_prime[:, None, :])
    b_vec = torch.where(enters, d.new_full((), -1.0 / k),
                        d.new_full((), 0.0))
    t = t_query.to(d.dtype)[:, None]
    ai = (a_vec[:, :, None, :] + b_vec[:, :, None, :] * t).abs()
    at = (a[..., None] + t_query.to(d.dtype)).abs()
    cnt = (live[:, None, None, :] & (ai >= at[..., None])).sum(-1)
    return (cnt + 1.0).to(d.dtype) / (st.n[:, None, None] + 1.0)


__all__ = ["RegStreamState", "init", "grow", "intervals", "pvalues"]
