"""Exact incremental/decremental k-NN regression state (paper Section 8.1),
batched over tenants. Counterpart of ``repro/regression/stream.py``; see
its module docstring for the ring layout and the invariants that keep
the streamed statistics equal to ``regression.fit`` on the live window:
lists in fit's order (ascending, ties toward the earliest arrival),
BIG slots carrying the row's own label, and distance rows computed in the
fixed-order ``sq_dists`` form ``fit`` uses.

Every leaf has a leading tenant axis ``S``. Where arrival order decides
between equal distances (the new point's own list), the ``(S, cap)`` row
is gathered into arrival order and the lowest index wins
(``regression.topk_lowest``), JAX's ``top_k`` tie rule. Operations update
the state in place and return it (the torch form of the JAX package's
donation).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch._device import BIG, resolve
from repro_torch.core.online import (drop_backfill, fsum, next_aid,
                                     ring_age, ring_live, ring_mod,
                                     ring_slots)
from repro_torch.core.regression import KnnRegState, topk_lowest
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import div_k, on_device


@dataclass
class RegStreamState:
    """Capacity-padded streaming k-NN regression state (ring layout),
    batched over tenants. Slots ``(head + i) % wrap``, ``i < n``, are
    live in arrival order; never-written slots hold zeros in ``X``/``y``
    and BIG in ``D``/``nbr_d``; slots that left the window may hold stale
    values and are masked by every reader."""

    X: torch.Tensor  # (S, cap, p)
    y: torch.Tensor  # (S, cap)
    D: torch.Tensor  # (S, cap, cap) live pairwise distances, BIG elsewhere
    nbr_d: torch.Tensor  # (S, cap, k) k nearest distances, ascending
    nbr_y: torch.Tensor  # (S, cap, k) their labels, same order
    n: torch.Tensor  # (S,) int32 live count
    head: torch.Tensor  # (S,) int32 slot of the oldest live point
    aid: torch.Tensor  # (S, cap) int32 arrival ids (monotone at insert)
    wrap: torch.Tensor  # (S,) int32 ring modulus (slots >= wrap inert)
    nbr_a: torch.Tensor  # (S, cap, k) int32 neighbours' arrival ids

    @property
    def capacity(self) -> int:
        return self.D.shape[-1]

    def leaves(self) -> list[torch.Tensor]:
        """The ten leaves in the JAX ``tree_flatten`` order."""
        return [self.X, self.y, self.D, self.nbr_d, self.nbr_y, self.n,
                self.head, self.aid, self.wrap, self.nbr_a]

    @classmethod
    def from_leaves(cls, leaves) -> "RegStreamState":
        return cls(*leaves)

    def clone(self) -> "RegStreamState":
        return RegStreamState.from_leaves([t.clone() for t in self.leaves()])


def init(capacity: int, p: int, k: int, *, n_sessions: int = 1,
         dtype=torch.float32, wrap: int | None = None,
         device=None) -> RegStreamState:
    """Fresh empty state. ``wrap`` (default: the capacity) is the ring
    modulus; a sliding engine confines its ring to the ``[:wrap]``
    block."""
    if capacity < k:
        raise ValueError(
            f"capacity {capacity} < k {k}: the k-best machinery needs at "
            "least k rows")
    dev = resolve(device)
    S = n_sessions
    i32 = dict(dtype=torch.int32, device=dev)
    return RegStreamState(
        X=torch.zeros((S, capacity, p), dtype=dtype, device=dev),
        y=torch.zeros((S, capacity), dtype=dtype, device=dev),
        D=torch.full((S, capacity, capacity), BIG, dtype=dtype, device=dev),
        nbr_d=torch.full((S, capacity, k), BIG, dtype=dtype, device=dev),
        nbr_y=torch.zeros((S, capacity, k), dtype=dtype, device=dev),
        n=torch.zeros((S,), **i32),
        head=torch.zeros((S,), **i32),
        aid=torch.zeros((S, capacity), **i32),
        wrap=torch.full((S,), capacity if wrap is None else wrap, **i32),
        nbr_a=torch.zeros((S, capacity, k), **i32),
    )


def _arrival(st: RegStreamState):
    """``(slots, live)``: the rank -> slot permutation ``(S, cap)`` and
    the rank mask ``rank < n``."""
    cap = st.capacity
    slots = ring_slots(cap, st.head, st.wrap).long()
    ranks = torch.arange(cap, device=st.n.device)
    return slots, ranks < st.n[:, None]


def _gather_rows(t: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``t (S, cap, ...)`` with its rows gathered through ``slots``."""
    idx = slots.view(slots.shape + (1,) * (t.dim() - 2)).expand(
        slots.shape + t.shape[2:])
    return t.gather(1, idx)


def _gathered(st: RegStreamState, slots, live, n) -> RegStreamState:
    """Every O(cap) leaf gathered through the rank -> slot map ``slots
    (S, cap)`` (head 0, wrap = cap, the linear layout's inert fills off
    ``live``), ``n`` live points; ``D`` is passed through untouched."""
    l3 = live[..., None]
    return RegStreamState(
        X=torch.where(l3, _gather_rows(st.X, slots), 0.0),
        y=torch.where(live, st.y.gather(1, slots), 0.0),
        D=st.D,
        nbr_d=torch.where(l3, _gather_rows(st.nbr_d, slots), BIG),
        nbr_y=torch.where(l3, _gather_rows(st.nbr_y, slots), 0.0),
        n=n,
        head=torch.zeros_like(st.head),
        aid=torch.where(live, st.aid.gather(1, slots), 0),
        wrap=torch.full_like(st.wrap, st.capacity),
        nbr_a=torch.where(l3, _gather_rows(st.nbr_a, slots), 0))


def _gathered_D(D, slots, live) -> torch.Tensor:
    """``D (S, cap, cap)`` with rows and columns gathered through
    ``slots``, BIG off ``live``."""
    S, cap = slots.shape
    D = D.gather(1, slots[:, :, None].expand(S, cap, cap))
    D = D.gather(2, slots[:, None, :].expand(S, cap, cap))
    return torch.where(live[:, :, None] & live[:, None, :], D, BIG)


def arrival_view(st: RegStreamState) -> RegStreamState:
    """The state with every O(cap) leaf in arrival order (head 0, the
    linear layout's inert fills beyond ``n``); ``D`` is passed through
    untouched (still ring-indexed)."""
    return _gathered(st, *_arrival(st), st.n)


def to_linear(st: RegStreamState) -> RegStreamState:
    """Full linear normalization, ``D`` included (a new state): leaf for
    leaf what the same window served through the linear layout holds.
    Absolute arrival ids are preserved (the lists ``nbr_a`` reference
    them by value); they are not renumbered."""
    slots, live = _arrival(st)
    view = _gathered(st, slots, live, st.n.clone())
    view.D = _gathered_D(st.D, slots, live)
    return view


def arrival_stats(st: RegStreamState, *, k):
    """Arrival-ordered ``(X, y, a_prime, upd, kth, kth_label, live)``,
    each ``(S, cap, ..)``: the one gather behind every regression read.
    The per-row statistics are computed in slot space in fit's
    expressions (``a_prime = y - fsum(nbr_y) / k``) and then gathered;
    rows beyond ``n`` carry the inert fills."""
    a_prime_s = st.y - div_k(fsum(st.nbr_y), k)
    upd_s = a_prime_s + div_k(st.nbr_y[..., -1], k)
    slots, live = _arrival(st)
    rows = lambda t, fill: torch.where(live, t.gather(1, slots), fill)  # noqa
    X = torch.where(live[..., None], _gather_rows(st.X, slots), 0.0)
    return (X, rows(st.y, 0.0), rows(a_prime_s, 0.0), rows(upd_s, 0.0),
            rows(st.nbr_d[..., -1], BIG), rows(st.nbr_y[..., -1], 0.0),
            live)


def state_view(st: RegStreamState, *, k) -> KnnRegState:
    """The capacity-padded ``KnnRegState`` this stream state encodes,
    rows in arrival order: live rows carry exactly ``regression.fit``'s
    bits once ``n >= k``; rows beyond ``n`` are inert fills."""
    X, y, a_prime, _, kth_d, kth_y, _ = arrival_stats(st, k=k)
    return KnnRegState(X, y, a_prime, kth_d, kth_y)


def _own_list(st: RegStreamState, d_row, y_new, *, k):
    """The new point's own ``(distances, labels)`` k-NN list from its
    distance row ``d_row (S, cap)``, taken in arrival order so equal
    distances go to the earliest arrival. Returns ``(own_d, own_y, y_sel,
    own_a)``: ``y_sel`` are the selected labels (the pricing path's
    ``a``), ``own_a`` the selected arrival ids. BIG slots carry the new
    point's own label ``y_new (S,)`` and id 0. The new point's slot is
    never at a live rank, so ``own_y`` needs no post-learn labels."""
    slots, live = _arrival(st)
    d_arr = torch.where(live, d_row.gather(1, slots), BIG)
    own_d, idx = topk_lowest(d_arr, k)
    y_sel = torch.where(live, st.y.gather(1, slots), 0.0).gather(1, idx)
    a_arr = torch.where(live, st.aid.gather(1, slots), 0)
    big = own_d >= BIG
    own_y = torch.where(big, y_new[:, None].to(y_sel.dtype), y_sel)
    own_a = torch.where(big, 0, a_arr.gather(1, idx))
    return own_d, own_y, y_sel, own_a


def observe(st: RegStreamState, x_new, y_new, *, k):
    """Learn one example per tenant in O(cap k), in place: the paper's
    incremental update at slot ``(head + n) % wrap``. Returns ``(st,
    d_row)``, the live-masked distance row. Precondition: ``n < wrap``."""
    ar = torch.arange(st.y.shape[0], device=st.y.device)
    idx = ring_mod(st.head + st.n, st.wrap).long()
    y_new = on_device(y_new, st.y.device, st.y.dtype)
    new_aid = next_aid(st.aid, st.head, st.n, st.wrap)
    d_row, nbr_d, nbr_y, nbr_a, _ = kops.stream_tick(
        st.X, st.y, st.nbr_d, st.nbr_y, x_new, y_new, st.n, mode="reg",
        head=st.head, wrap=st.wrap, nbr_a=st.nbr_a, new_aid=new_aid)
    own_d, own_y, _, own_a = _own_list(st, d_row, y_new, k=k)
    st.D[ar, idx, :] = d_row
    st.D[ar, :, idx] = d_row
    nbr_d[ar, idx], nbr_y[ar, idx], nbr_a[ar, idx] = own_d, own_y, own_a
    st.X[ar, idx] = x_new.to(st.X.dtype)
    st.y[ar, idx] = y_new
    st.aid[ar, idx] = new_aid
    st.nbr_d, st.nbr_y, st.nbr_a = nbr_d, nbr_y, nbr_a
    st.n = st.n + 1
    return st, d_row


def evict_oldest(st: RegStreamState, *, k) -> RegStreamState:
    """Forget every tenant's oldest live point, in place: a head advance
    plus the labeled list repair of ``core.online.drop_backfill``.
    Precondition: ``n >= 1``."""
    cap = st.capacity
    ar = torch.arange(st.n.shape[0], device=st.n.device)
    hl = st.head.long()
    dcol = st.D[ar, :, hl]
    head2 = ring_mod(st.head + 1, st.wrap)
    n2 = st.n - 1
    live2 = ring_live(cap, head2, n2, st.wrap)
    affected = live2 & (dcol <= st.nbr_d[..., -1])
    st.nbr_d, st.nbr_y, st.nbr_a = drop_backfill(
        st.nbr_d, dcol, live2[:, None, :], st.D, affected, k=k,
        Ly=st.nbr_y, La=st.nbr_a, ys=st.y, aid=st.aid,
        age=ring_age(cap, head2, st.wrap),
        slots=ring_slots(cap, head2, st.wrap), aid0=st.aid[ar, hl])
    st.n, st.head = n2, head2
    return st


def evict(st: RegStreamState, i, *, k) -> RegStreamState:
    """Forget each tenant's ``i``-th oldest live point (``i`` an int or
    ``(S,)``; 0 is the oldest), in O(cap^2): a new state, normalized to
    head 0 and wrap = cap. The survivors are gathered into arrival order
    (arbitrary mid-window forgetting has no O(cap) repair, as in the JAX
    ``_evict``); the rows whose list may have held the evicted point
    (``d <= kth``: on ties membership cannot be told from the distance)
    are recomputed from the stored distances with ``topk_lowest``, whose
    lowest-index rule is, in arrival order, fit's earliest-arrival rule.
    Arrival ids keep their values. Precondition: ``0 <= i < n``."""
    cap = st.capacity
    S, dev = st.n.shape[0], st.n.device
    i = torch.as_tensor(i, dtype=torch.int32, device=dev).expand(S)
    ar = torch.arange(S, device=dev)
    dcol = st.D[ar, :, ring_mod(st.head + i, st.wrap).long()]
    affected = (ring_live(cap, st.head, st.n, st.wrap)
                & (dcol <= st.nbr_d[..., -1]))

    # survivor slots in arrival order, rank i dropped; the last rank maps
    # to itself and takes the inert fill below
    ranks = torch.arange(cap, device=dev)
    src = torch.clamp(ranks + (ranks >= i[:, None]), max=cap - 1)
    slots = ring_slots(cap, st.head, st.wrap).long().gather(1, src)
    n2 = st.n - 1
    live2 = ranks < n2[:, None]
    out = _gathered(st, slots, live2, n2)
    out.D = _gathered_D(st.D, slots, live2)
    aff = (live2 & affected.gather(1, slots))[..., None]

    rec_d, idx = topk_lowest(out.D, k)
    flat = idx.flatten(1)
    big = rec_d >= BIG
    rec_y = out.y.gather(1, flat).view(idx.shape)
    rec_a = out.aid.gather(1, flat).view(idx.shape)
    out.nbr_d = torch.where(aff, rec_d, out.nbr_d)
    out.nbr_y = torch.where(aff, torch.where(big, out.y[..., None], rec_y),
                            out.nbr_y)
    out.nbr_a = torch.where(aff, torch.where(big, 0, rec_a), out.nbr_a)
    return out


def from_fit(X, y, *, k, capacity: int, device=None) -> RegStreamState:
    """Seed a state from batch data ``X (S, n, p)``, ``y (S, n)`` by
    replaying ``observe``: the incremental construction is the fit."""
    dev = resolve(device)
    X = torch.as_tensor(X, device=dev)
    y = torch.as_tensor(y, dtype=X.dtype, device=dev)
    st = init(capacity, X.shape[-1], k, n_sessions=X.shape[0],
              dtype=X.dtype, device=dev)
    for t in range(X.shape[1]):
        st, _ = observe(st, X[:, t].contiguous(), y[:, t], k=k)
    return st


__all__ = ["RegStreamState", "init", "arrival_view", "to_linear",
           "arrival_stats", "state_view", "observe", "evict",
           "evict_oldest", "from_fit"]
