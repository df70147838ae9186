"""Plain PyTorch versions of the port's kernels — the semantics of record.

Counterpart of ``repro/kernels/ref.py``. Every function takes a leading
tenant axis ``S`` (``X (S, cap, p)``, per-tenant scalars ``(S,)``) and
also accepts the unbatched form (``X (cap, p)``, scalars ``()``).

Sums over the feature axis run in a fixed sequential order, one column at
a time, with separate multiply and add roundings. That is the order the
CUDA kernels use, so a row's result depends neither on the batch shape
nor on how the work is tiled: the kernels can be held to these functions
bit for bit, and the port's exactness properties (engine == sequential
sessions, chunked == per-tick) do not hinge on a library reduction order.

The attention functions of the LM substrate are the exception: they take
the ``(B, S, H, D)`` layout of ``repro/models`` and PyTorch's own einsum
and softmax reductions, and the kernel is held to them at a stated
tolerance, not bit for bit.
"""
from __future__ import annotations

import torch

_BIG = 1e30  # matches core.online.BIG


def fsum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right, one rounding per add; 0
    over an empty axis (``jnp.sum``'s, so k = 1 scores are their k-th
    distance)."""
    if a.shape[-1] == 0:
        return a.new_zeros(a.shape[:-1])
    acc = a[..., 0]
    for j in range(1, a.shape[-1]):
        acc = acc + a[..., j]
    return acc


def _sumsq(A: torch.Tensor) -> torch.Tensor:
    """``sum_j A[..., j]^2`` over the last axis in fixed order."""
    acc = torch.zeros(A.shape[:-1], dtype=A.dtype, device=A.device)
    for j in range(A.shape[-1]):
        acc = acc + A[..., j] * A[..., j]
    return acc


def sq_dists(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Squared distances ``(..., m, n)`` between rows of ``A (..., m, p)``
    and ``B (..., n, p)`` in the ``|a|^2 + |b|^2 - 2 a.b`` form, every sum
    in fixed order over ``p``. Row-decomposable: row ``i`` does not depend
    on ``m``."""
    ab = torch.zeros(A.shape[:-1] + (B.shape[-2],), dtype=A.dtype,
                     device=A.device)
    for j in range(A.shape[-1]):
        ab = ab + A[..., :, None, j] * B[..., None, :, j]
    return _sumsq(A)[..., :, None] + _sumsq(B)[..., None, :] - 2.0 * ab


def row_dists(X: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Row-difference distances ``sqrt(max(sum_j (X[.., i, j] - x[.., j])^2,
    0))``: ``X (..., cap, p)``, ``x (..., p)`` -> ``(..., cap)``."""
    acc = torch.zeros(X.shape[:-1], dtype=X.dtype, device=X.device)
    for j in range(X.shape[-1]):
        t = X[..., j] - x[..., None, j]
        acc = acc + t * t
    return torch.sqrt(torch.clamp(acc, min=0.0))


def kde_kvals(d2: torch.Tensor, h: float) -> torch.Tensor:
    """``exp(-max(d2, 0) / f32(2 h^2))``, the KDE measure's kernel values
    (``repro/core/measures/kde.py::_kvals``: clamp, then divide). The
    divisor is a device scalar, so the division is IEEE on every device
    (see ``div_k``)."""
    return torch.exp(-torch.clamp(d2, min=0.0) / d2.new_full((),
                                                              2.0 * h * h))


def kde_rowsums(A, B, y_A, y_B, h: float, exclude_diag: bool = False,
                n_labels: int | None = None):
    """Masked Gaussian row sums ``out[i] = sum_j [y_B[j] == y_A[i]] [j !=
    i if exclude_diag] exp(-max(d2_ij, 0) / f32(2 h^2))`` for ``A (m, p)``,
    ``B (n, p)``, int labels ``y_A (m,)``, ``y_B (n,)`` -> ``(m,)``. With
    ``y_A=None``, every label's sum: ``(m, n_labels)``, column ``l`` the
    sums with target label ``l``.

    ``d2`` is ``sq_dists`` (fixed order); the sum over ``j`` runs left to
    right, one rounding per add, as in the CUDA kernel. Unlike
    ``repro/kernels/ref.py::kde_rowsums`` (which divides without a clamp)
    it follows the measure's ``_kvals``: clamp, then divide."""
    K = kde_kvals(sq_dists(A, B), h)
    m, n = K.shape
    if exclude_diag:
        K = torch.where(torch.eye(m, n, dtype=torch.bool, device=K.device),
                        0.0, K)
    if y_A is None:
        y_A = torch.arange(n_labels, dtype=y_B.dtype,
                           device=y_B.device).expand(m, n_labels)
    mask = y_A[..., None] == y_B  # (m, n) or (m, L, n)
    acc = K.new_zeros(mask.shape[:-1])
    for j in range(n):
        Kj = K[:, j] if y_A.dim() == 1 else K[:, j, None]
        acc = acc + torch.where(mask[..., j], Kj, 0.0)
    return acc


def cp_knn_counts(X, y, sum_same, kth_same, X_test, alpha):
    """Fused simplified-k-NN CP update + p-value partial counts.

    ``counts[t, l] = #{i : alpha_i(t, l) >= alpha[t, l]}`` where
    ``alpha_i`` is ``sum_same[i]``, updated to ``sum_same[i] - kth_same[i]
    + d(x_i, x_t)`` when ``y[i] == l`` and ``d < kth_same[i]``. Columns
    with label -1 and sum -BIG are never counted. ``alpha (..., m, L)``;
    returns int32 ``(..., m, L)``.
    """
    d = torch.sqrt(torch.clamp(sq_dists(X_test, X), min=0.0))  # (.., m, n)
    labels = torch.arange(alpha.shape[-1], dtype=y.dtype, device=y.device)
    same = y[..., None, :] == labels[:, None]  # (.., L, n)
    upd = same[..., None, :, :] & (d[..., :, None, :]
                                   < kth_same[..., None, None, :])
    alphas = torch.where(
        upd, (sum_same - kth_same)[..., None, None, :] + d[..., :, None, :],
        sum_same[..., None, None, :])
    return (alphas >= alpha[..., None]).sum(-1, dtype=torch.int32)


def div_k(t: torch.Tensor, k: int) -> torch.Tensor:
    """``t / k`` as one IEEE division on every device. PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's reciprocal
    instead, one rounding away from the CPU and from the kernels. The
    divisor is filled on the device (``new_full``): a ``new_tensor`` would
    copy from pageable host memory and synchronise the stream."""
    return t / t.new_full((), float(k))


def interval_ge(a_i, b_i, a, eps: float = 1e-12):
    """``(lo, hi)`` of ``{t : |a_i + b_i t| >= |a + t|}``, broadcast over
    the inputs: the roots of ``(b_i^2 - 1) t^2 + 2 (a_i b_i - a) t + (a_i^2
    - a^2)``, the quadratic branch for ``|b_i| < 1`` and the linear one for
    ``|b_i| == 1`` (k = 1). Empty sets are ``(+inf, -inf)``. One operation
    per rounding, in the order of ``repro.core.regression._interval_ge``;
    the CUDA ``interval_sweep`` kernel repeats it with ``_rn`` intrinsics.
    """
    inf = float("inf")
    A2 = b_i * b_i - 1.0
    B1 = a_i * b_i - a
    C0 = a_i * a_i - a * a
    disc = B1 * B1 - A2 * C0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    denom = torch.where(A2.abs() < eps, 1.0, A2)
    r1 = (-B1 + sq) / denom
    r2 = (-B1 - sq) / denom
    real = disc >= 0.0
    quad_lo = torch.where(real, torch.minimum(r1, r2), inf)
    quad_hi = torch.where(real, torch.maximum(r1, r2), -inf)
    t0 = -C0 / torch.where(B1.abs() < eps, 1.0, 2.0 * B1)
    flat_lo = torch.where(C0 >= 0.0, -inf, inf)
    lin_lo = torch.where(B1 > eps, t0, torch.where(B1 < -eps, -inf, flat_lo))
    lin_hi = torch.where(B1 > eps, inf, torch.where(B1 < -eps, t0, -flat_lo))
    is_quad = A2.abs() >= eps
    return (torch.where(is_quad, quad_lo, lin_lo),
            torch.where(is_quad, quad_hi, lin_hi))


def reg_interval_endpoints(X, a_prime, kth_dist, kth_label, live, X_test,
                           a_test, k: int, eps: float = 1e-12):
    """Regression-CP critical points, the plain ``interval_sweep``.

    Per (test row t, training row i): the distance ``d(x_i, x_t)``
    (``sq_dists``, fixed order), the O(1) update of the affine score
    coefficients ``a_i = a'_i + [d < kth_i] kth_label_i / k``, ``b_i in
    {0, -1/k}``, and ``interval_ge(a_i, b_i, a_test[t])``. ``X (..., n,
    p)``, the per-row statistics and ``live (..., n)``, ``X_test (..., m,
    p)``, ``a_test (..., m)`` -> ``lo, hi (..., m, n)``; non-live columns
    are ``(+inf, -inf)``. Counterpart of ``repro/kernels/ref.py::
    reg_interval_endpoints``."""
    inf = float("inf")
    d = torch.sqrt(torch.clamp(sq_dists(X_test, X), min=0.0))
    upd = a_prime + div_k(kth_label, k)
    lv = live[..., None, :]
    enters = lv & (d < kth_dist[..., None, :])
    a_i = torch.where(enters, upd[..., None, :], a_prime[..., None, :])
    b_i = torch.where(enters, a_prime.new_full((), -1.0 / k),
                      a_prime.new_full((), 0.0))
    lo, hi = interval_ge(a_i, b_i, a_test[..., :, None], eps)
    return torch.where(lv, lo, inf), torch.where(lv, hi, -inf)


def on_device(v, device, dtype=torch.int32) -> torch.Tensor:
    """``v`` (a Python number or a tensor) as ``dtype`` on ``device``; a
    number is filled there, so no copy from the host waits for the card."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    if isinstance(v, (int, float)):
        return torch.full((), v, dtype=dtype, device=device)
    return torch.as_tensor(v, dtype=dtype, device=device)


def ring_age(cap: int, head: torch.Tensor, wrap) -> torch.Tensor:
    """``(..., cap)`` arrival age of each slot (0 = oldest) of rings at
    ``head`` with modulus ``wrap``; slots ``>= wrap`` get the sentinel age
    ``cap`` (never live)."""
    idx = torch.arange(cap, dtype=torch.int32, device=head.device)
    h = head[..., None]
    m = on_device(wrap, head.device)[..., None]
    raw = torch.where(idx >= h, idx - h, idx - h + m)
    return torch.where(idx < m, raw, cap)


def ring_slots(cap: int, head, wrap) -> torch.Tensor:
    """``(..., cap)`` slot of each arrival rank, ``(head + i) % wrap``."""
    s = torch.arange(cap, dtype=torch.int32, device=head.device) + head[..., None]
    m = on_device(wrap, head.device)[..., None]
    return torch.where(s >= m, s - m, s)


def _ring_live(cap: int, head, n, wrap=None) -> torch.Tensor:
    """``(..., cap)`` live mask of a ring window: slot ``(head + i) % wrap``
    is live for ``i in [0, n)``; slots ``>= wrap`` never are. ``head=None``
    is the linear layout ``arange(cap) < n``."""
    n = torch.as_tensor(n)
    if head is None:
        return torch.arange(cap, dtype=torch.int32,
                            device=n.device) < n[..., None]
    head = torch.as_tensor(head, device=n.device)
    return ring_age(cap, head, cap if wrap is None else wrap) < n[..., None]


def _lift(*ts):
    return tuple(None if t is None else torch.as_tensor(t)[None]
                 for t in ts)


def stream_update(X, y, nbr_d, nbr_y, x_new, y_new, n, *, mode: str,
                  head=None, wrap=None):
    """Sort-based streaming observe front end: distance row + k-best merge.

    ``mode="class"``: row-difference distances, a row's list admits the
    candidate iff same label; ``nbr_y`` passes through. ``mode="reg"``:
    ``sq_dists`` distances, a row admits the candidate iff it beats the
    k-th distance; labels ride along, inserted after equal distances; BIG
    slots carry the row's own label. Returns ``(d_row, nbr_d', nbr_y')``.
    """
    if X.dim() == 2:
        out = stream_update(*_lift(X, y, nbr_d, nbr_y, x_new, y_new, n),
                            mode=mode, head=_lift(head)[0],
                            wrap=_lift(wrap)[0])
        return tuple(None if o is None else o[0] for o in out)
    cap, k = nbr_d.shape[-2:]
    live = _ring_live(cap, head, n, wrap)
    y_new = torch.as_tensor(y_new, device=X.device)
    if mode == "class":
        d = torch.where(live, row_dists(X, x_new), _BIG)
        same = (y == y_new[:, None]) & live
        cand = torch.where(same, d, _BIG)
        merged = torch.sort(torch.cat([nbr_d, cand[..., None]], -1),
                            dim=-1, stable=True).values[..., :k]
        return d, merged, nbr_y
    if mode != "reg":
        raise ValueError(f"unknown stream_update mode {mode!r}")
    d = torch.sqrt(torch.clamp(sq_dists(x_new[:, None], X)[:, 0], min=0.0))
    d_row = torch.where(live, d, _BIG)
    enters = live & (d < nbr_d[..., -1])
    cand_d = torch.where(enters, d, _BIG)
    merged_d = torch.cat([nbr_d, cand_d[..., None]], -1)
    merged_y = torch.cat(
        [nbr_y, y_new.to(nbr_y.dtype)[:, None, None].expand(-1, cap, 1)], -1)
    order = torch.sort(merged_d, dim=-1, stable=True).indices
    nd = torch.gather(merged_d, -1, order)[..., :k]
    ny = torch.gather(merged_y, -1, order)[..., :k]
    ny = torch.where(nd >= _BIG, y[..., None].to(ny.dtype), ny)
    return d_row, nd, ny


def _ordered_insert(L: torch.Tensor, c: torch.Tensor):
    """Branch-free ordered insert of ``c (..., cap)`` into each ascending
    row of ``L (..., cap, k)``, strictly after equal values, largest entry
    dropped. Bit-identical to the stable sort with the candidate last.
    Returns ``(newL, pos, cols)``."""
    k = L.shape[-1]
    pos = (L <= c[..., None]).sum(-1, keepdim=True, dtype=torch.int32)
    cols = torch.arange(k, dtype=torch.int32, device=L.device)
    Lsh = torch.cat([L[..., :1], L[..., :k - 1]], -1)
    newL = torch.where(cols < pos, L,
                       torch.where(cols == pos, c[..., None], Lsh))
    return newL, pos, cols


def stream_update_fast(X, y, nbr_d, nbr_y, x_new, y_new, n, *, mode: str,
                       head=None, wrap=None):
    """Sortless form of ``stream_update``, bit-identical to it (every
    output is a selected input value). The CPU path of the port."""
    if X.dim() == 2:
        out = stream_update_fast(
            *_lift(X, y, nbr_d, nbr_y, x_new, y_new, n), mode=mode,
            head=_lift(head)[0], wrap=_lift(wrap)[0])
        return tuple(None if o is None else o[0] for o in out)
    cap = nbr_d.shape[-2]
    live = _ring_live(cap, head, n, wrap)
    y_new = torch.as_tensor(y_new, device=X.device)
    if mode == "class":
        d = torch.where(live, row_dists(X, x_new), _BIG)
        same = (y == y_new[:, None]) & live
        merged, _, _ = _ordered_insert(nbr_d, torch.where(same, d, _BIG))
        return d, merged, nbr_y
    if mode != "reg":
        raise ValueError(f"unknown stream_update mode {mode!r}")
    d = torch.sqrt(torch.clamp(sq_dists(x_new[:, None], X)[:, 0], min=0.0))
    d_row = torch.where(live, d, _BIG)
    enters = live & (d < nbr_d[..., -1])
    newL, pos, cols = _ordered_insert(nbr_d, torch.where(enters, d, _BIG))
    k = nbr_d.shape[-1]
    Ysh = torch.cat([nbr_y[..., :1], nbr_y[..., :k - 1]], -1)
    yn = y_new.to(nbr_y.dtype)[:, None, None]
    newY = torch.where(cols < pos, nbr_y, torch.where(cols == pos, yn, Ysh))
    newY = torch.where(newL >= _BIG, y[..., None].to(newY.dtype), newY)
    return d_row, newL, newY


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
    Lup = torch.cat([L[..., 1:], torch.full_like(L[..., :1], _BIG)], -1)
    if k >= 2:
        tprime = torch.where(pos0 <= k - 2, L[..., k - 1], L[..., k - 2])
    else:
        tprime = torch.full_like(es, -1.0)
    mprime = ((L == tprime[..., None]).sum(-1, dtype=torch.int32)
              - (es == tprime).to(torch.int32))
    t = tprime[..., None]
    cnt = (cand & (Ds == t)).sum(-1, dtype=torch.int32)
    gtmin = torch.where(cand & (Ds > t), Ds, _BIG).amin(-1)
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
    big = newL >= _BIG
    newLy = torch.where(big, ys[..., None], newLy)
    newLa = torch.where(big, 0, newLa)
    return (torch.where(a, newL, L), torch.where(a, newLy, Ly),
            torch.where(a, newLa, La))


def stream_tick(X, y, nbr_d, nbr_y, x_new, y_new, n, *, mode: str, head,
                wrap, D=None, ev=None, aid=None, nbr_a=None, new_aid=None):
    """The serving tick's front end, the plain version of the fused
    ``stream_update`` kernels: the composition the serving ticks ran
    before the fusion, on the window ``(head, n, wrap)`` after the
    eviction.

    With ``ev (S,)`` bool, the tenants with ``ev`` set have just evicted
    the point at slot ``head - 1`` (mod ``wrap``): ``drop_backfill``
    repairs, in place, the rows whose lists may hold it (live, its
    distance -- its column of ``D (S, w, w)`` -- at most the k-th best;
    classification: the same label), over every row of every tenant and
    the ``(S, w, w)`` candidate masks. Regression repairs the label and
    arrival-id lists too (``aid (S, w)``). Then ``stream_update_fast``;
    in regression the new point's id ``new_aid (S,)`` enters the id lists
    ``nbr_a`` at the same place, BIG slots carrying id 0 (regression
    always carries ids). Also returns the repaired lists' fixed-order sum
    the tick's scores start from: ``fsum(nbr_d[..., :-1])`` in class mode
    (the score without its k-th term), ``fsum(nbr_y)`` in reg mode.
    Returns ``(d_row, nbr_d', nbr_y', nbr_a', lsum)``, ``nbr_a'`` None in
    class mode."""
    reg = mode == "reg"
    if ev is not None:
        S, w, k = nbr_d.shape
        ar = torch.arange(S, device=nbr_d.device)
        wrap_ = on_device(wrap, head.device)
        hd = torch.where(head == 0, wrap_ - 1, head - 1).long()
        es = D[ar, :, hd]  # (S, w): distances to the evicted point
        live = _ring_live(w, head, n, wrap_)
        aff = ev[:, None] & live & (es <= nbr_d[..., -1])
        if reg:
            out = drop_backfill(
                nbr_d, es, live[:, None, :], D, aff, k=k, Ly=nbr_y, La=nbr_a,
                ys=y, aid=aid, age=ring_age(w, head, wrap_),
                slots=ring_slots(w, head, wrap_), aid0=aid[ar, hd])
            for t, o in zip((nbr_d, nbr_y, nbr_a), out):
                t.copy_(o)
        else:
            aff &= y == y.gather(1, hd[:, None])
            cand = (y[:, :, None] == y[:, None, :]) & live[:, None, :]
            nbr_d.copy_(drop_backfill(nbr_d, es, cand, D, aff, k=k))
    lsum = fsum(nbr_y) if reg else fsum(nbr_d[..., :-1])
    d, nd, ny = stream_update_fast(X, y, nbr_d, nbr_y, x_new, y_new, n,
                                   mode=mode, head=head, wrap=wrap)
    if not reg:
        return d, nd, ny, None, lsum
    live = _ring_live(nbr_d.shape[-2], head, n, wrap)
    c = torch.where(live & (d < nbr_d[..., -1]), d, _BIG)
    _, pos, cols = _ordered_insert(nbr_d, c)
    k = nbr_d.shape[-1]
    Ash = torch.cat([nbr_a[..., :1], nbr_a[..., :k - 1]], -1)
    na = torch.where(cols < pos, nbr_a,
                     torch.where(cols == pos, new_aid[:, None, None], Ash))
    return d, nd, ny, torch.where(nd >= _BIG, 0, na), lsum


# ---------------------------------------------------------------------------
# the bootstrap measure's extra-trees
# ---------------------------------------------------------------------------


def first_argmax(c: torch.Tensor) -> torch.Tensor:
    """int32 index of the first maximum over the last axis (numpy's and
    JAX's ``argmax`` tie rule, written out)."""
    idx = torch.arange(c.shape[-1], device=c.device)
    first = torch.where(c == c.amax(-1, keepdim=True), idx, c.shape[-1])
    return first.amin(-1).to(torch.int32)


def boot_fit_tree(X, y, w, feat_choice, thr_u, n_labels: int, depth: int):
    """One weighted extra-tree, node by node in breadth-first order: the
    counterpart of ``repro/kernels/ref.py::boot_fit_tree``, the semantics
    of record of ``boot_forest.fit_forest``.

    ``X (m, p)`` f32 rows, ``y (m,)`` labels, ``w (m,)`` integer
    multiplicities, ``feat_choice (n_nodes,)`` and ``thr_u (n_nodes,)``
    the node's pre-drawn feature and uniform. A node's leaf label is the
    first maximum of its weighted label counts (0 when empty); an internal
    node splits iff its weighted count is above 1 and ``hi > lo`` over its
    drawn rows' feature values, at ``t = lo + u * (hi - lo)`` in three f32
    roundings; a row goes right iff its value is above ``t``. Returns
    ``(feat, thresh, leaf)`` each ``(n_nodes,)``: feature -1 and
    threshold 0 where a node does not split."""
    m = X.shape[0]
    nn = 2 ** (depth + 1) - 1
    n_internal = 2 ** depth - 1
    dev = X.device
    y, w = y.long(), w.long()
    node_of = torch.zeros(m, dtype=torch.int64, device=dev)
    feat = torch.full((nn,), -1, dtype=torch.int32, device=dev)
    thresh = torch.zeros(nn, dtype=torch.float32, device=dev)
    leaf = torch.zeros(nn, dtype=torch.int32, device=dev)
    for node in range(nn):
        mask = (node_of == node) & (w > 0)
        cnt = torch.zeros(n_labels, dtype=torch.int64, device=dev)
        cnt.index_add_(0, y, torch.where(mask, w, 0))
        leaf[node] = first_argmax(cnt)
        if node >= n_internal:
            continue
        f = int(feat_choice[node])
        col = X[:, f]
        lo = torch.where(mask, col, float("inf")).amin()
        hi = torch.where(mask, col, float("-inf")).amax()
        if int(cnt.sum()) > 1 and bool(hi > lo):
            t = lo + thr_u[node] * (hi - lo)
            feat[node], thresh[node] = f, t
            node_of = torch.where(
                mask, torch.where(col > t, 2 * node + 2, 2 * node + 1),
                node_of)
    return feat, thresh, leaf


def boot_predict_tree(feat, thresh, leaf, Xq):
    """Labels ``(q,)`` of one tree ``(feat, thresh, leaf)`` on the rows of
    ``Xq (q, p)``: each row descends while its node splits (right iff its
    feature value is above the threshold) and reads the leaf label of the
    deepest node it reaches."""
    q = Xq.shape[0]
    depth = (feat.shape[0] + 1).bit_length() - 2
    rows = torch.arange(q, device=Xq.device)
    node = torch.zeros(q, dtype=torch.int64, device=Xq.device)
    for _ in range(depth):
        f = feat[node].long()
        xv = Xq[rows, f.clamp(min=0)]
        node = torch.where(
            f >= 0, torch.where(xv > thresh[node], 2 * node + 2,
                                2 * node + 1), node)
    return leaf[node]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

_NEG_INF = -1e30  # finite mask value, as in the Pallas kernel


def _attn_mask(Sq: int, Skv: int, causal: bool, window, device,
               q0: int = 0, k0: int = 0, bq=None, bk=None) -> torch.Tensor:
    """``(bq, bk)`` keep-mask of query rows ``q0..`` and keys ``k0..`` at
    right-aligned positions (query ``i`` sits at ``i + Skv - Sq``)."""
    bq = Sq if bq is None else bq
    bk = Skv if bk is None else bk
    q_pos = torch.arange(q0, q0 + bq, device=device)[:, None] + (Skv - Sq)
    k_pos = torch.arange(k0, k0 + bk, device=device)[None, :]
    mask = k_pos < Skv
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    return mask


def _logits(qg, kf, scale: float, softcap):
    """f32 logits ``(B, Hkv, rep, bq, bk)`` of grouped queries ``qg (B, bq,
    Hkv, rep, D)`` against ``kf (B, bk, Hkv, D)``: scale, then the tanh
    cap."""
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """Attention with the Pallas kernel's arithmetic: q, k, v upcast to
    f32, logits in f32 (scale, then ``softcap * tanh(s / softcap)``),
    masked to -1e30, softmax, ``P.V`` in f32, cast to q's dtype.

    ``q (B, Sq, H, D)``, ``k, v (B, Skv, Hkv, D)`` with ``H % Hkv == 0``;
    query head ``h`` reads kv head ``h // (H // Hkv)`` (GQA, without
    repeating K/V). Positions are right-aligned (``q_pos = i + Skv - Sq``);
    ``window`` keeps keys in ``(q_pos - window, q_pos]``. Unlike
    ``repro/kernels/ref.py::flash_attention`` it does not round the logits
    and probabilities to a bf16 input's dtype: the two agree in f32."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / D ** 0.5
    qg = q.float().reshape(B, Sq, Hkv, rep, D)
    s = _logits(qg, k.float(), scale, softcap)
    mask = _attn_mask(Sq, Skv, causal, window, q.device)
    s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int | None = None,
                      scale: float | None = None,
                      softcap: float | None = None, block_q: int = 1024,
                      block_k: int = 1024) -> torch.Tensor:
    """``flash_attention`` with O(S * block) memory: each query block scans
    the key blocks with running (max, denominator, accumulator) statistics,
    the online softmax of ``repro/kernels/ref.py::chunked_attention``."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    for q0 in range(0, Sq, block_q):
        bq = min(block_q, Sq - q0)
        qg = q[:, q0:q0 + bq].float().reshape(B, bq, Hkv, rep, D)
        m_run = q.new_full((B, Hkv, rep, bq), _NEG_INF, dtype=torch.float32)
        l_run = torch.zeros_like(m_run)
        acc = q.new_zeros((B, Hkv, rep, bq, D), dtype=torch.float32)
        for k0 in range(0, Skv, block_k):
            bk = min(block_k, Skv - k0)
            s = _logits(qg, kf[:, k0:k0 + bk], scale, softcap)
            mask = _attn_mask(Sq, Skv, causal, window, q.device, q0, k0, bq,
                              bk)
            s = torch.where(mask, s, _NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p, vf[:, k0:k0 + bk])
            m_run = m_new
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]
        out[:, q0:q0 + bq] = o.permute(0, 3, 1, 2, 4).reshape(
            B, bq, H, D).to(q.dtype)
    return out


__all__ = ["fsum", "sq_dists", "row_dists", "cp_knn_counts", "div_k", "kde_kvals",
           "kde_rowsums", "interval_ge",
           "reg_interval_endpoints", "ring_age", "ring_slots", "stream_update",
           "stream_update_fast", "drop_backfill_core", "drop_backfill",
           "stream_tick", "first_argmax", "boot_fit_tree",
           "boot_predict_tree", "flash_attention", "chunked_attention"]
