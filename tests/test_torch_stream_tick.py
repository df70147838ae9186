"""The fused serving tick: the eviction repair of the rows that held the
evicted point, then the distance row and the ordered insert, in one call
(``ref.stream_tick``, the plain version of the ``stream_update`` kernels,
which repair only those rows).

Held bitwise (``torch.equal``) against the composition the serving ticks
ran before the fusion, written out here with its own gate:
``core.online.drop_backfill`` (which repairs every row of every tenant
over the ``(S, w, w)`` distances and keeps the affected ones, reading the
evicted point's column of ``D``) followed by ``ref.stream_update_fast``
and, in regression, the arrival-id merge. The
states come from the port's own CPU engines: wrapped rings with the head
off the block start, gated lanes, ``wmax`` views whose rows have the
capacity's stride, quantized one-hot features for ties at ``tprime``,
lists not yet full, k = 1 and k = 15, and arrival ids across the int32
wraparound. The engines themselves are held to the JAX engines by
``test_torch_serving.py`` and ``test_torch_regression.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import online  # noqa: E402
from repro_torch.core.online import (next_aid, ring_age, ring_live,  # noqa: E402,E501
                                     ring_mod, ring_slots)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.regression import RegressionServingEngine  # noqa: E402
from repro_torch.regression import session as rsess  # noqa: E402
from repro_torch.regression import stream as rstream  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import session as csess  # noqa: E402

BIG = 1e30
S, P, CHECKED = 5, 6, 6  # tenants, features, ticks checked per case


def _traffic(seed, T, data, mode):
    """``xs (T, S, P)``, ``ys``, ``taus (T, S)``, ``active (T, S)`` (about
    a fifth of the lanes idle). ``onehot``: each point is a unit vector or
    zero, so distances take three values and tie everywhere."""
    rng = np.random.default_rng(seed)
    if data == "onehot":
        j = rng.integers(0, P + 1, (T, S))
        xs = np.eye(P + 1, P, dtype=np.float32)[j]
    else:
        xs = rng.standard_normal((T, S, P), dtype=np.float32)
    if mode == "class":
        ys = rng.integers(0, 2, (T, S)).astype(np.int32)
        xs = xs + (ys[..., None] if data != "onehot" else 0)
    elif data == "onehot":
        ys = rng.integers(0, 3, (T, S)).astype(np.float32)
    else:
        ys = xs.sum(-1) + 0.1 * rng.standard_normal((T, S), dtype=np.float32)
    taus = rng.random((T, S), dtype=np.float32)
    active = rng.random((T, S)) < 0.8
    return xs.astype(np.float32), ys, taus, active


def _evicting(st_n, head, wrap, act, window):
    ev = act & (st_n >= window)
    s = ev.to(torch.int32)
    return ev, ring_mod(head + s, wrap), st_n - s


def _mutate(mutation, aff, every, live_ev, es, nearest):
    """The repair's row gate and evicted distances under a mutation:
    ``every`` repairs each row the repair could touch (the same bits:
    where ``es`` exceeds the k-th best it drops nothing); ``wrong_es``
    also repairs every other live row of the evicting tenants, as if
    each had lost its nearest neighbour (other bits wherever k >= 2)."""
    if mutation == "every":
        return every, es
    if mutation == "wrong_es":
        un = live_ev & ~aff
        return aff | un, torch.where(un, nearest, es)
    return aff, es


def _class_composition(st, x, y, act, window, k, w, mutation=None):
    """The tick's front end as the classification session ran it before
    the fusion: ``(b1, d, merged, tick, stats)``."""
    knn = st.knn
    Xw, yw, bw, Dw = knn.X[:, :w], knn.y[:, :w], knn.best[:, :w], \
        st.D[:, :w, :w]
    ev, head1, n1 = _evicting(knn.n, st.head, st.wrap, act, window)
    ar, hl = torch.arange(S), st.head.long()
    dcol = Dw[ar, :, hl]
    live1 = ring_live(w, head1, n1, st.wrap)
    every = ev[:, None] & (yw == yw.gather(1, hl[:, None])) & live1
    aff = every & (dcol <= bw[..., -1])
    gate, es = _mutate(mutation, aff, every, ev[:, None] & live1, dcol,
                       bw[..., 0])
    cand = (yw[:, :, None] == yw[:, None, :]) & live1[:, None, :]
    b1 = online.drop_backfill(bw, es, cand, Dw, gate, k=k)
    d, merged, _ = ref.stream_update_fast(Xw, yw, b1, None, x, y, n1,
                                          mode="class", head=head1,
                                          wrap=st.wrap)
    _, _, _, b, tp, _ = online.drop_backfill_core(bw, dcol, cand, Dw, k=k)
    stats = dict(affected=int(aff.sum()), ties=int((aff & (b == tp)).sum()),
                 evicting=int(ev.sum()), idle=int((~act).sum()),
                 unaffected=int((ev[:, None] & live1 & ~aff).sum()))
    return b1, d, merged, (ev, head1, n1), stats


def _merge_aid(nbr_d_pre, nbr_a, cand_d, new_aid, merged_d):
    """The arrival-id insert the regression tick ran after the kernel
    before the fusion."""
    k = nbr_d_pre.shape[-1]
    pos = (nbr_d_pre <= cand_d[..., None]).sum(-1, keepdim=True,
                                               dtype=torch.int32)
    cols = torch.arange(k)
    Ash = torch.cat([nbr_a[..., :1], nbr_a[..., :k - 1]], -1)
    newA = torch.where(cols < pos, nbr_a,
                       torch.where(cols == pos, new_aid[:, None, None], Ash))
    return torch.where(merged_d >= BIG, 0, newA)


def _reg_composition(st, x, y, act, window, k, w, mutation=None):
    """The tick's front end as the regression session ran it before the
    fusion: ``((L1, Ly1, La1), (d_row, Lm, Lym, Lam), tick, stats)``."""
    Xw, yw, aidw, Dw = st.X[:, :w], st.y[:, :w], st.aid[:, :w], \
        st.D[:, :w, :w]
    Lw, Lyw, Law = st.nbr_d[:, :w], st.nbr_y[:, :w], st.nbr_a[:, :w]
    ev, head1, n1 = _evicting(st.n, st.head, st.wrap, act, window)
    ar, hl = torch.arange(S), st.head.long()
    dcol = Dw[ar, :, hl]
    live1 = ring_live(w, head1, n1, st.wrap)
    every = ev[:, None] & live1
    aff = every & (dcol <= Lw[..., -1])
    gate, es = _mutate(mutation, aff, every, every, dcol, Lw[..., 0])
    lists = online.drop_backfill(
        Lw, es, live1[:, None, :], Dw, gate, k=k, Ly=Lyw, La=Law, ys=yw,
        aid=aidw, age=ring_age(w, head1, st.wrap),
        slots=ring_slots(w, head1, st.wrap), aid0=aidw[ar, hl])
    L1, Ly1, La1 = lists
    d_row, Lm, Lym = ref.stream_update_fast(Xw, yw, L1, Ly1, x, y, n1,
                                            mode="reg", head=head1,
                                            wrap=st.wrap)
    new_aid = next_aid(aidw, head1, n1, st.wrap)
    enters = live1 & (d_row < L1[..., -1])
    Lam = _merge_aid(L1, La1, torch.where(enters, d_row, BIG), new_aid, Lm)
    _, _, _, b, tp, _ = online.drop_backfill_core(Lw, dcol, live1[:, None, :],
                                                  Dw, k=k)
    stats = dict(affected=int(aff.sum()), ties=int((aff & (b == tp)).sum()),
                 evicting=int(ev.sum()), idle=int((~act).sum()),
                 unaffected=int((every & ~aff).sum()))
    return lists, (d_row, Lm, Lym, Lam), (ev, head1, n1, new_aid), stats


def _check_class_tick(st, x, y, act, window, k, w):
    b1, d, merged, (ev, head1, n1), stats = _class_composition(
        st, x, y, act, window, k, w)
    c = st.clone()
    got = ref.stream_tick(c.knn.X[:, :w], c.knn.y[:, :w], c.knn.best[:, :w],
                          None, x, y, n1, mode="class", head=head1,
                          wrap=c.wrap, D=c.D[:, :w, :w], ev=ev)
    assert torch.equal(c.knn.best[:, :w], b1), "repaired lists, in place"
    assert torch.equal(c.knn.best[:, w:], st.knn.best[:, w:])
    assert torch.equal(got[0], d) and torch.equal(got[1], merged)
    assert got[2] is None and got[3] is None
    assert torch.equal(got[4], online.fsum(b1[..., :-1])), "score base"
    every = _class_composition(st, x, y, act, window, k, w, "every")[0]
    assert torch.equal(every, b1), "every row repaired: the same bits"
    wrong = _class_composition(st, x, y, act, window, k, w, "wrong_es")[0]
    stats["gate_seen"] = int((wrong != b1).any(-1).sum())
    return stats


def _check_reg_tick(st, x, y, act, window, k, w):
    lists, outs, (ev, head1, n1, new_aid), stats = _reg_composition(
        st, x, y, act, window, k, w)
    c = st.clone()
    got = ref.stream_tick(
        c.X[:, :w], c.y[:, :w], c.nbr_d[:, :w], c.nbr_y[:, :w], x, y, n1,
        mode="reg", head=head1, wrap=c.wrap, D=c.D[:, :w, :w], ev=ev,
        aid=c.aid[:, :w], nbr_a=c.nbr_a[:, :w], new_aid=new_aid)
    for t, want, name in zip((c.nbr_d, c.nbr_y, c.nbr_a), lists,
                             ("nbr_d", "nbr_y", "nbr_a")):
        assert torch.equal(t[:, :w], want), f"repaired {name}, in place"
    for t, u in zip((c.nbr_d, c.nbr_y, c.nbr_a),
                    (st.nbr_d, st.nbr_y, st.nbr_a)):
        assert torch.equal(t[:, w:], u[:, w:])
    for g, want, name in zip(got, outs, ("d_row", "Lm", "Lym", "Lam")):
        assert torch.equal(g, want), name
    assert torch.equal(got[4], online.fsum(lists[1])), "label sum"
    every = _reg_composition(st, x, y, act, window, k, w, "every")[0]
    assert all(torch.equal(a, b) for a, b in zip(every, lists)), \
        "every row repaired: the same bits"
    wrong = _reg_composition(st, x, y, act, window, k, w, "wrong_es")[0]
    stats["gate_seen"] = sum(int((a != b).any(-1).sum())
                             for a, b in zip(wrong, lists))
    return stats


def _shift_ids(st, window):
    """The same state with every arrival id moved by one constant so
    that the live window's ids straddle the int32 wraparound."""
    c = (2**31 - 1) - int(st.aid.max()) + window // 2

    def move(a):
        return ((a.long() + c + 2**31) % 2**32 - 2**31).to(torch.int32)

    st.aid = move(st.aid)
    st.nbr_a = torch.where(st.nbr_d < BIG, move(st.nbr_a), 0)
    return st


def _sum(stats):
    return {key: sum(s[key] for s in stats) for key in stats[0]}


CASES = [  # k, window, capacity, data
    (1, 24, 24, "gauss"),      # k = 1: tprime = -1
    (3, 30, 40, "onehot"),     # ties at tprime; wmax view (stride 40)
    (15, 20, 48, "onehot"),    # lists never full; wmax view (stride 48)
    (15, 64, 64, "gauss"),     # full lists
]


@pytest.mark.parametrize("k,window,cap,data", CASES)
def test_class_tick_equals_repair_then_update(k, window, cap, data):
    T0 = 2 * window + 7  # the heads end off the block start
    xs, ys, taus, active = _traffic(k + window, T0 + CHECKED, data, "class")
    eng = ServingEngine(n_sessions=S, capacity=cap, dim=P, k=k,
                        window=window, device="cpu")
    st, _ = eng.observe_many(eng.init_state(), xs[:T0], ys[:T0], taus[:T0],
                             active[:T0])
    w = eng._wmax
    assert bool((st.head > 0).any()), "rings wrapped off the block start"
    stats = []
    for t in range(T0, T0 + CHECKED):
        x, y, a = (torch.from_numpy(v[t]) for v in (xs, ys, active))
        stats.append(_check_class_tick(st, x, y, a, window, k, w))
        st, _ = eng.observe(st, xs[t], ys[t], taus[t], active[t])
    tot = _sum(stats)
    assert tot["affected"] > 0 and tot["evicting"] > 0 and tot["idle"] > 0
    # at k = 1 a repair recomputes the nearest neighbour: no mutation shows
    seen = k >= 2 and tot["unaffected"] > 0
    assert (tot["gate_seen"] > 0) == seen, "the gate is seen"
    if data == "onehot":
        assert tot["ties"] > 0, "some backfills at tprime"


@pytest.mark.parametrize("k,window,cap,data", CASES)
def test_reg_tick_equals_repair_then_update(k, window, cap, data):
    T0 = 2 * window + 7
    xs, ys, taus, active = _traffic(k + window, T0 + CHECKED, data, "reg")
    eng = RegressionServingEngine(n_sessions=S, capacity=cap, dim=P, k=k,
                                  window=window, device="cpu")
    st, _ = eng.observe_many(eng.init_state(), xs[:T0], ys[:T0], taus[:T0],
                             active[:T0])
    w = eng._wmax
    stats = []
    for t in range(T0, T0 + CHECKED):
        x, y, a = (torch.from_numpy(v[t]) for v in (xs, ys, active))
        stats.append(_check_reg_tick(st, x, y, a, window, k, w))
        st, _ = eng.observe(st, xs[t], ys[t], taus[t], active[t])
    tot = _sum(stats)
    assert tot["affected"] > 0 and tot["evicting"] > 0 and tot["idle"] > 0
    # at k = 1 a repair recomputes the nearest neighbour: no mutation shows
    seen = k >= 2 and tot["unaffected"] > 0
    assert (tot["gate_seen"] > 0) == seen, "the gate is seen"
    if data == "onehot":
        assert tot["ties"] > 0, "some backfills at tprime"


@pytest.mark.parametrize("k", [3, 15])
def test_reg_tick_across_the_int32_id_wraparound(k):
    window, cap = 24, 32
    T0 = 2 * window + 5
    xs, ys, taus, active = _traffic(7 * k, T0 + 3 * CHECKED, "onehot", "reg")
    eng = RegressionServingEngine(n_sessions=S, capacity=cap, dim=P, k=k,
                                  window=window, device="cpu")
    st, _ = eng.observe_many(eng.init_state(), xs[:T0], ys[:T0], taus[:T0],
                             active[:T0])
    st = _shift_ids(st, window)
    ids = st.aid[:, :eng._wmax]
    assert bool((ids < 0).any()) and bool((ids > 2**30).any())
    stats = []
    for t in range(T0, T0 + 3 * CHECKED):
        x, y, a = (torch.from_numpy(v[t]) for v in (xs, ys, active))
        stats.append(_check_reg_tick(st, x, y, a, window, k, eng._wmax))
        st, _ = eng.observe(st, xs[t], ys[t], taus[t], active[t])
    tot = _sum(stats)
    assert tot["affected"] > 0 and tot["ties"] > 0


def test_non_evicting_tick_is_stream_update():
    """Without ``ev`` the fused tick is ``stream_update_fast`` and leaves
    the lists alone; with ``nbr_a`` the ids follow the insert."""
    xs, ys, _, _ = _traffic(3, 1, "gauss", "reg")
    rng = np.random.default_rng(5)
    cap, k = 16, 4
    X = torch.from_numpy(rng.standard_normal((S, cap, P), dtype=np.float32))
    y = torch.from_numpy(rng.standard_normal((S, cap), dtype=np.float32))
    L = torch.from_numpy(np.sort(rng.uniform(1, 6, (S, cap, k)), -1)
                         .astype(np.float32))
    Ly = torch.from_numpy(rng.standard_normal((S, cap, k), dtype=np.float32))
    La = torch.from_numpy(rng.integers(0, 99, (S, cap, k), dtype=np.int32))
    n = torch.tensor([0, 3, 16, 9, 12], dtype=torch.int32)
    head = torch.tensor([0, 14, 5, 0, 11], dtype=torch.int32)
    wrap = torch.full((S,), cap, dtype=torch.int32)
    new_aid = torch.tensor([0, 7, 40, 9, 2**31 - 1], dtype=torch.int32)
    x, yn = torch.from_numpy(xs[0]), torch.from_numpy(ys[0])
    before = [t.clone() for t in (L, Ly, La)]
    got = ref.stream_tick(X, y, L, Ly, x, yn, n, mode="reg", head=head,
                          wrap=wrap, nbr_a=La, new_aid=new_aid)
    want = ref.stream_update_fast(X, y, L, Ly, x, yn, n, mode="reg",
                                  head=head, wrap=wrap)
    for g, w_ in zip(got[:3], want):
        assert torch.equal(g, w_)
    assert all(torch.equal(a, b) for a, b in zip((L, Ly, La), before))
    live = ref._ring_live(cap, head, n, wrap)
    c = torch.where(live & (got[0] < L[..., -1]), got[0], BIG)
    assert torch.equal(got[3], _merge_aid(L, La, c, new_aid, got[1]))
    assert bool((got[3] == 2**31 - 1).any())


def test_class_engine_at_k1_matches_jax_engine():
    """k = 1 in the classification engine: the scores' base is the sum of
    no entries (0, ``jnp.sum``'s), the repair's tprime -1. Leaves and
    p-values against the JAX engine at ``test_torch_serving``'s
    tolerances."""
    import test_torch_serving as ts

    kw = dict(n_sessions=ts.S, capacity=16, dim=ts.DIM, k=1, n_labels=2,
              window=12)
    xs, ys, taus, active = ts._traffic(21)
    _, jstate, _, tstate, jp, tp = ts._run_both(
        kw, xs, ys, taus, active, [(0, 9), (9, ts.T)])
    np.testing.assert_allclose(tp, jp, atol=1e-6)
    assert (ts.convert.session_to_numpy(tstate)[5] > 0).any()
    ts._assert_leaves(ts.convert.session_to_numpy(tstate),
                      [np.asarray(a) for a in
                       ts.jax.tree_util.tree_leaves(jstate)])


def _symmetric(D):
    return torch.equal(D, D.transpose(1, 2))


def test_distance_matrix_stays_bitwise_symmetric():
    """The fused repair reads the evicted point's row of ``D`` for its
    column: ``D`` stays symmetric bit for bit over long wrapped, gated
    runs of both engines (sliding with a ``wmax`` block, and grow mode),
    and through ``to_linear`` and ``grow``."""
    T = 200
    for mode in ("class", "reg"):
        xs, ys, taus, active = _traffic(11, T, "gauss", mode)
        Eng = ServingEngine if mode == "class" else RegressionServingEngine
        for window, cap in ((30, 40), (None, 8)):
            eng = Eng(n_sessions=S, capacity=cap, dim=P, k=3, window=window,
                      device="cpu")
            st = eng.init_state()
            for c0 in range(0, T, 40):
                st, _ = eng.observe_many(st, xs[c0:c0 + 40], ys[c0:c0 + 40],
                                         taus[c0:c0 + 40],
                                         active[c0:c0 + 40])
                assert _symmetric(st.D), (mode, window, c0)
            if window is not None:
                assert bool((st.head > 0).any())
            lin = (csess.to_linear(st) if mode == "class"
                   else rstream.to_linear(st))
            grown = csess.grow(st) if mode == "class" else rsess.grow(st)
            assert _symmetric(lin.D) and _symmetric(grown.D)


def _to(st, dev):
    """A copy of ``st`` on ``dev`` (the lists are repaired in place)."""
    return type(st).from_leaves([t.to(dev, copy=True) for t in st.leaves()])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["class", "reg"])
def test_fused_kernel_matches_plain_on_the_card(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.stream_update import stream_update

    k, window, cap = 3, 30, 40
    T0 = 2 * window + 7
    xs, ys, taus, active = _traffic(9, T0 + 1, "onehot", mode)
    Eng = ServingEngine if mode == "class" else RegressionServingEngine
    eng = Eng(n_sessions=S, capacity=cap, dim=P, k=k, window=window,
              device="cpu")
    st, _ = eng.observe_many(eng.init_state(), xs[:T0], ys[:T0], taus[:T0],
                             active[:T0])
    w = eng._wmax
    x, y, a = (torch.from_numpy(v[T0]) for v in (xs, ys, active))
    n0 = st.knn.n if mode == "class" else st.n
    ev, head1, n1 = _evicting(n0, st.head, st.wrap, a, window)
    for evict in (ev, None):
        outs = []
        for dev in ("cpu", "cuda"):
            c = _to(st, dev)
            tick = dict(head=head1.to(dev), wrap=c.wrap,
                        D=c.D[:, :w, :w], ev=None if evict is None
                        else evict.to(dev))
            if mode == "class":
                lists = (c.knn.best,)
                args = (c.knn.X[:, :w], c.knn.y[:, :w], c.knn.best[:, :w],
                        None)
            else:
                lists = (c.nbr_d, c.nbr_y, c.nbr_a)
                aidw = c.aid[:, :w]
                tick.update(aid=aidw, nbr_a=c.nbr_a[:, :w],
                            new_aid=next_aid(aidw, tick["head"],
                                             n1.to(dev), c.wrap))
                args = (c.X[:, :w], c.y[:, :w], c.nbr_d[:, :w],
                        c.nbr_y[:, :w])
            fn = ref.stream_tick if dev == "cpu" else stream_update
            got = fn(*args, x.to(dev), y.to(dev), n1.to(dev), mode=mode,
                     **tick)
            outs.append([None if t is None else t.cpu()
                         for t in (*got, *lists)])
        for g, want in zip(outs[1], outs[0]):
            assert (g is None and want is None) or torch.equal(g, want)
