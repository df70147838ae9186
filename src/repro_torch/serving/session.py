"""Tenant-batched capacity-padded CP sessions with exact decremental
eviction. Counterpart of ``repro/serving/session.py``; see its module
docstring for the ring layout and the invariants, which hold here
unchanged.

One ``Session`` holds every tenant of an engine (leading axis ``S``). The
JAX engine donates its state so that XLA updates the ``(S, cap, cap)``
distance matrices in place; the port writes in place outright: a tick
touches one row and one column of each tenant's ``D`` through advanced
indexing over the tenant axis (O(S*w) bytes) and never copies a
``(cap, cap)`` buffer.

``_sliding_step_compact`` keeps the historic linear layout, whose
eviction compacts every leaf (``D`` included, O(S*w*w) bytes a tick):
the ring tick's bit-oracle and its baseline (``layout="compact"`` on the
engine).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch._device import BIG, resolve
from repro_torch.core import online
from repro_torch.core.online import (OnlineKnnState, cshift, cshift2,
                                     drop_backfill, fsum, next_aid,
                                     ring_live, ring_mod, ring_slots)
from repro_torch.kernels import ops as kops


@dataclass
class Session:
    """Every tenant's sliding-window CP state: k-NN state + live
    distances, batched over the leading tenant axis."""

    knn: OnlineKnnState
    D: torch.Tensor  # (S, cap, cap) live pairwise distances, BIG elsewhere
    head: torch.Tensor  # (S,) int32 slot of the oldest live point
    aid: torch.Tensor  # (S, cap) int32 arrival ids (monotone at insert)
    wrap: torch.Tensor  # (S,) int32 ring modulus (slots >= wrap inert)

    @property
    def capacity(self) -> int:
        return self.D.shape[-1]

    @property
    def n(self) -> torch.Tensor:
        """``(S,)`` live counts (the engines' occupancy checks read it)."""
        return self.knn.n

    def leaves(self) -> list[torch.Tensor]:
        """The eight leaves in the JAX ``tree_flatten`` order: ``X, y,
        best, n, D, head, aid, wrap``."""
        k = self.knn
        return [k.X, k.y, k.best, k.n, self.D, self.head, self.aid,
                self.wrap]

    @classmethod
    def from_leaves(cls, leaves) -> "Session":
        X, y, best, n, D, head, aid, wrap = leaves
        return cls(OnlineKnnState(X, y, best, n), D, head, aid, wrap)

    def clone(self) -> "Session":
        return Session.from_leaves([t.clone() for t in self.leaves()])


def init(capacity: int, p: int, k: int, *, n_sessions: int = 1,
         dtype=torch.float32, wrap: int | None = None,
         device=None) -> Session:
    """Fresh empty sessions. ``wrap`` (default: the capacity) is the ring
    modulus; a sliding engine confines its ring to the ``[:wrap]`` block."""
    if capacity < k:
        raise ValueError(
            f"capacity {capacity} < k {k}: the k-best machinery needs at "
            "least k rows")
    dev = resolve(device)
    S = n_sessions
    return Session(
        knn=online.init(capacity, p, k, n_sessions=S, dtype=dtype,
                        device=dev),
        D=torch.full((S, capacity, capacity), BIG, dtype=dtype, device=dev),
        head=torch.zeros((S,), dtype=torch.int32, device=dev),
        aid=torch.zeros((S, capacity), dtype=torch.int32, device=dev),
        wrap=torch.full((S,), capacity if wrap is None else wrap,
                        dtype=torch.int32, device=dev),
    )


def _sliding_step(sess: Session, x_new, y_new, tau, window, active, *, k,
                  evictable: bool = True, wmax: int | None = None):
    """One fused sliding-window tick for every tenant, in place:
    evict-if-full, price, learn, all gated by ``active (S,)``.

    Inactive lanes rewrite their own values (state bitwise unchanged) and
    return a NaN p-value. ``evictable=False`` drops the eviction (grow
    mode). ``wmax`` is the caller's promise that occupancy never exceeds
    it: the ring then lives in the ``[:wmax]`` block of every leaf, whose
    views the kernels read in place. Returns ``(sess, p (S,))``.
    """
    knn = sess.knn
    S, cap = knn.X.shape[:2]
    w = cap if wmax is None or wmax >= cap else wmax
    Xw, yw, bw = knn.X[:, :w], knn.y[:, :w], knn.best[:, :w]
    Dw = sess.D[:, :w, :w]
    head, n, wrap = sess.head, knn.n, sess.wrap
    act = active
    ar = torch.arange(S, device=knn.X.device)

    if evictable:
        ev = act & (n >= window)
        s = ev.to(torch.int32)
        head1 = ring_mod(head + s, wrap)
        n1 = n - s
    else:
        ev, head1, n1 = None, head, n

    # repair (one launch with the learn: the lists that held the evicted
    # point, in place, so bw now holds them), price, learn -- through
    # the same code path as core.online.run_stream
    p, d, merged, idx = online._observe_impl(
        OnlineKnnState(Xw, yw, bw, n1), x_new, y_new, tau, k=k,
        head=head1, wrap=wrap, D=Dw, ev=ev)

    il = idx.long()
    a1 = act[:, None]
    row = torch.where(a1, d, Dw[ar, il, :])  # D is symmetric
    sess.D[ar, il, :w] = row
    sess.D[ar, :w, il] = row
    knn.X[ar, il] = torch.where(a1, x_new.to(knn.X.dtype), knn.X[ar, il])
    knn.y[ar, il] = torch.where(act, y_new.to(knn.y.dtype), knn.y[ar, il])
    knn.best[:, :w] = torch.where(act[:, None, None], merged, bw)
    new_aid = next_aid(sess.aid[:, :w], head1, n1, wrap)
    sess.aid[ar, il] = torch.where(act, new_aid, sess.aid[ar, il])
    knn.n = torch.where(act, n1 + 1, n1)
    sess.head = head1
    p = torch.where(act, p, torch.full_like(p, float("nan")))
    return sess, p


def _sliding_step_compact(sess: Session, x_new, y_new, tau, window, active,
                          *, k, evictable: bool = True,
                          wmax: int | None = None):
    """The historic linear-layout tick, the ring tick's bit-oracle: the
    semantics of ``_sliding_step`` with arrival order kept by position.
    An evicting tenant compacts every leaf down one row (``D`` one row
    and one column, ``cshift``), the plain ``drop_backfill`` repairs the
    lists over the compacted state, and the learn goes through
    ``online._observe_impl`` in the linear layout (on the card the
    ``stream_update`` kernel without eviction). ``wmax`` runs the step
    on the ``[:wmax]`` block. Precondition: ``head == 0``, which the
    step keeps. Replaces ``sess``'s leaves (the block's in place) and
    returns ``(sess, p (S,))``."""
    knn = sess.knn
    S, cap = knn.X.shape[:2]
    if wmax is not None and wmax < cap:
        sub = Session(OnlineKnnState(knn.X[:, :wmax], knn.y[:, :wmax],
                                     knn.best[:, :wmax], knn.n),
                      sess.D[:, :wmax, :wmax], sess.head,
                      sess.aid[:, :wmax], sess.wrap.clamp(max=wmax))
        sub, p = _sliding_step_compact(sub, x_new, y_new, tau, window,
                                       active, k=k, evictable=evictable)
        knn.X[:, :wmax] = sub.knn.X
        knn.y[:, :wmax] = sub.knn.y
        knn.best[:, :wmax] = sub.knn.best
        sess.D[:, :wmax, :wmax] = sub.D
        sess.aid[:, :wmax] = sub.aid
        knn.n = sub.knn.n
        return sess, p
    act = active
    dev = knn.X.device
    ar = torch.arange(S, device=dev)
    ranks = torch.arange(cap, dtype=torch.int32, device=dev)
    if evictable:
        ev = act & (knn.n >= window)
        s = ev.to(torch.int32)
        dcol = sess.D[:, :, 0]
        affected = (ev[:, None] & (knn.y == knn.y[:, :1])
                    & (ranks < knn.n[:, None]) & (dcol <= knn.best[..., -1]))
        X1, y1 = cshift(knn.X, s, 0.0), cshift(knn.y, s, -1)
        L1, aid1 = cshift(knn.best, s, BIG), cshift(sess.aid, s, 0)
        D1 = cshift2(sess.D, s, BIG)
        n1 = knn.n - s
        cand = ((y1[:, :, None] == y1[:, None, :])
                & (ranks < n1[:, None])[:, None, :])
        best1 = drop_backfill(L1, cshift(dcol, s, BIG), cand, D1,
                              cshift(affected, s, False), k=k)
        del cand
    else:
        X1, y1, best1, D1 = knn.X, knn.y, knn.best, sess.D
        aid1, n1 = sess.aid, knn.n

    p, d, merged, _ = online._observe_impl(
        OnlineKnnState(X1, y1, best1, n1), x_new, y_new, tau, k=k)

    # gated writes at slot n1; the clamp keeps an inactive lane of a full
    # window in bounds (it rewrites its own values there)
    il = n1.clamp(max=cap - 1).long()
    a1 = act[:, None]
    row = torch.where(a1, d, D1[ar, il, :])  # D is symmetric
    D1[ar, il, :] = row
    D1[ar, :, il] = row
    X1[ar, il] = torch.where(a1, x_new.to(X1.dtype), X1[ar, il])
    y1[ar, il] = torch.where(act, y_new.to(y1.dtype), y1[ar, il])
    new_aid = next_aid(aid1, torch.zeros_like(n1), n1,
                       torch.full_like(n1, cap))
    aid1[ar, il] = torch.where(act, new_aid, aid1[ar, il])
    knn.X, knn.y = X1, y1
    knn.best = torch.where(act[:, None, None], merged, best1)
    knn.n = torch.where(act, n1 + 1, n1)
    sess.D, sess.aid = D1, aid1
    return sess, torch.where(act, p, torch.full_like(p, float("nan")))


def _observe_sliding(sess: Session, x_new, y_new, tau, window, *, k):
    """Evict-if-full then observe, every lane active: ``_sliding_step``
    with a per-tenant ``window``."""
    active = torch.ones_like(sess.head, dtype=torch.bool)
    return _sliding_step(sess, x_new, y_new, tau, window, active, k=k)


def _evict_oldest(sess: Session, *, k) -> Session:
    """Forget every tenant's oldest live point, in place, on the ring:
    only the head advances, and the lists that held the point (same
    label, its distance at most their k-th) are repaired by the plain
    ``drop_backfill`` from the stored distances. Nothing else moves.
    Precondition: ``n >= 1``."""
    knn = sess.knn
    S, cap = knn.X.shape[:2]
    ar = torch.arange(S, device=knn.X.device)
    hl = sess.head.long()
    dcol = sess.D[ar, :, hl]
    head2 = ring_mod(sess.head + 1, sess.wrap)
    n2 = knn.n - 1
    live2 = ring_live(cap, head2, n2, sess.wrap)
    affected = ((knn.y == knn.y[ar, hl][:, None]) & live2
                & (dcol <= knn.best[..., -1]))
    cand = (knn.y[:, :, None] == knn.y[:, None, :]) & live2[:, None, :]
    knn.best = drop_backfill(knn.best, dcol, cand, sess.D, affected, k=k)
    knn.n, sess.head = n2, head2
    return sess


def _observe(sess: Session, x_new, y_new, tau, *, k):
    """Price then learn one point per tenant, recording its distance row
    and column in ``D`` (in place). Precondition: ``n < wrap``."""
    active = torch.ones_like(sess.head, dtype=torch.bool)
    return _sliding_step(sess, x_new, y_new, tau, None, active, k=k,
                         evictable=False)


def to_linear(sess: Session) -> Session:
    """A new state in the linear layout (``head == 0``): every leaf
    gathered into arrival order, stale slots reset to the inert fills,
    arrival ids renumbered ``0..n-1``, ``wrap == cap`` — leaf for leaf
    what a fresh linear session fed the surviving window holds."""
    knn = sess.knn
    S, cap, p = knn.X.shape
    k = knn.best.shape[-1]
    slots = ring_slots(cap, sess.head, sess.wrap).long()  # (S, cap)
    ranks = torch.arange(cap, dtype=torch.int32, device=knn.X.device)
    live = ranks < knn.n[:, None]
    X = torch.where(live[..., None],
                    knn.X.gather(1, slots[..., None].expand(S, cap, p)), 0.0)
    y = torch.where(live, knn.y.gather(1, slots), -1)
    best = torch.where(
        live[..., None], knn.best.gather(1, slots[..., None].expand(S, cap, k)),
        BIG)
    D = sess.D.gather(1, slots[:, :, None].expand(S, cap, cap))
    D = D.gather(2, slots[:, None, :].expand(S, cap, cap))
    D = torch.where(live[:, :, None] & live[:, None, :], D, BIG)
    aid = torch.where(live, ranks, 0)
    return Session(OnlineKnnState(X, y, best, knn.n.clone()), D,
                   torch.zeros_like(sess.head), aid,
                   torch.full_like(sess.wrap, cap))


def grow(sess: Session, factor: int = 2) -> Session:
    """Multiply every tenant's capacity by ``factor`` (a new state),
    normalizing the ring to linear order first."""
    return repad(sess, sess.capacity * factor)


def repad(sess: Session, new_cap: int) -> Session:
    """Every tenant's capacity raised to ``new_cap`` (a new state): the
    ring normalised to linear order, every leaf padded with its inert
    fill. The fleet migrates a lane with it."""
    extra = new_cap - sess.capacity
    s = to_linear(sess)
    knn = s.knn
    return Session(
        knn=OnlineKnnState(
            X=F.pad(knn.X, (0, 0, 0, extra)),
            y=F.pad(knn.y, (0, extra), value=-1),
            best=F.pad(knn.best, (0, 0, 0, extra), value=BIG),
            n=knn.n,
        ),
        D=F.pad(s.D, (0, extra, 0, extra), value=BIG),
        head=s.head,
        aid=F.pad(s.aid, (0, extra)),
        wrap=torch.full_like(s.wrap, new_cap),
    )


def predict_pvalues(sess: Session, X_test, *, k, n_labels):
    """Read-only full-CP query: p-values ``(S, m, n_labels)`` for every
    label of every query row ``X_test (S, m, p)``.

    Candidate scores come from one masked top-k over the distance rows
    (``kops.sq_dists``, the pairwise kernel on CUDA); the score update and
    counts from ``kops.cp_knn_counts``, with non-live slots carrying the
    label -1 and sum -BIG. Rows whose k-best list is not full are left out
    of the kernel (its ``sum - kth + d`` would subtract the BIG padding)
    and counted here in the cancellation-safe ``base + (kth or d)`` form.
    """
    knn = sess.knn
    cap = knn.X.shape[1]
    live = ring_live(cap, sess.head, knn.n, sess.wrap)  # (S, cap)

    d = torch.sqrt(torch.clamp(kops.sq_dists(X_test, knn.X), min=0.0))
    labels = torch.arange(n_labels, dtype=knn.y.dtype, device=knn.y.device)
    same = (knn.y[:, None, :] == labels[:, None]) & live[:, None, :]
    dm = torch.where(same[:, None], d[:, :, None, :], BIG)  # (S, m, L, cap)
    alpha = fsum(-torch.topk(-dm, k, dim=-1).values)  # (S, m, L)

    kth = knn.best[..., -1]
    full = live & (kth < BIG)
    sum_same = torch.where(full, fsum(knn.best), -BIG)
    kth_same = torch.where(full, kth, -BIG)
    counts = kops.cp_knn_counts(
        knn.X, torch.where(live, knn.y, -1), sum_same, kth_same, X_test,
        alpha.contiguous(), n_labels)

    deficient = live & (kth >= BIG)
    base = fsum(knn.best[..., :-1])
    kth4 = kth[:, None, None, :]
    upd = same[:, None] & (d[:, :, None, :] < kth4)
    scores = base[:, None, None, :] + torch.where(upd, d[:, :, None, :], kth4)
    ge = (scores >= alpha[..., None]) & deficient[:, None, None, :]
    counts = counts + ge.sum(-1, dtype=torch.int32)
    return (counts + 1.0).to(knn.X.dtype) / (knn.n[:, None, None] + 1.0)


__all__ = ["Session", "init", "grow", "predict_pvalues", "to_linear"]
