"""The port's regression slice against the JAX ``RegressionServingEngine``,
and its exactness properties re-proved inside the port.

Path parity: both engines start from one state (carried across by
``repro_torch.serving.convert``) and get the same numpy traffic. ``(T,
S)`` p-values agree within 1e-5 (a flipped comparison moves a p-value by
at least 1/(n+1), so this is equality up to near-ties, which are
reported with their margin); float leaves within 1e-5 (the frameworks
sum over k in different orders); integer leaves exactly; intervals within
1e-4 with the NaN pattern exact on every query row without an
ill-conditioned critical point (at k == 1 about half the rows hold one:
a test point and its nearest training point that are each other's
nearest neighbours, whose exact set is the whole line).

Port-internal exactness is bitwise (``torch.equal``): streamed state ==
refit, lists == a fresh engine fed the surviving window, chunked ==
per-tick, engine == one-tenant engines, served intervals == the port's
``intervals_optimized(fit(window))``. ``intervals_optimized`` and
``intervals_standard`` compute the same scores by different roundings,
so they are held together as the JAX package holds its pair.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.regression import RegressionServingEngine as JaxEngine  # noqa: E402,E501
from repro_torch.core import regression as reg  # noqa: E402
from repro_torch.regression import RegressionServingEngine  # noqa: E402
from repro_torch.regression import session as rsess  # noqa: E402
from repro_torch.regression import stream as rstream  # noqa: E402
from repro_torch.serving import convert  # noqa: E402
from test_torch_regression_kernels import ill_conditioned  # noqa: E402

S, DIM, K, CAP, W, T = 4, 5, 3, 32, 24, 60
EPS = 0.1234567  # off every rank boundary eps * (n + 1)
INT_LEAVES = (5, 6, 7, 8, 9)  # n, head, aid, wrap, nbr_a


def _traffic(seed, T=T, S=S, dim=DIM, kind="linear", ragged=True):
    """Per-tenant linear labels ``y = <w_s, x> + 0.1 noise`` (the JAX
    launcher's regression workload); ``kind="ties"`` puts the points on
    a small integer grid with integer labels, so many distances and
    labels are exactly equal."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((S, dim)).astype(np.float32)
    if kind == "ties":
        xs = rng.integers(0, 2, (T, S, dim)).astype(np.float32)
        ys = rng.integers(0, 3, (T, S)).astype(np.float32)
    else:
        xs = rng.standard_normal((T, S, dim)).astype(np.float32)
        ys = (np.einsum("sd,tsd->ts", w, xs)
              + 0.1 * rng.standard_normal((T, S))).astype(np.float32)
    taus = rng.random((T, S)).astype(np.float32)
    active = rng.random((T, S)) < 0.8 if ragged else np.ones((T, S), bool)
    return xs, ys, taus, active


def _engine(**kw):
    args = dict(n_sessions=S, capacity=CAP, dim=DIM, k=K, window=W,
                device="cpu")
    args.update(kw)
    return RegressionServingEngine(**args)


def _assert_equal_state(a, b):
    for i, (la, lb) in enumerate(zip(a.leaves(), b.leaves())):
        assert torch.equal(la, lb), f"leaf {i}"


def _ill_rows(state, Xq, k):
    """``(S, m)`` count of each query row's ill-conditioned cells (see
    ``test_torch_regression_kernels.ill_conditioned``): where one sits,
    XLA's FMA-contracted root arithmetic and the port's per-operation
    rounding may legitimately disagree about that row's interval."""
    Xg, yg, ap, _, kth, kl, live = rstream.arrival_stats(state, k=k)
    d, a = rsess._test_score(yg, live, torch.from_numpy(np.array(Xq)), Xg,
                             k=k)
    return ill_conditioned(d, kth, live, ap, kl, a, k).sum(-1)


def _assert_pvalues_close(got, want, n_max):
    """Within 1e-5; NaN pattern exact. A difference is a near-tie: it
    must be a whole rank step, and it is reported with its size."""
    assert np.array_equal(np.isnan(got), np.isnan(want))
    diff = np.abs(np.nan_to_num(got) - np.nan_to_num(want))
    bad = diff > 1e-5
    assert not bad.any(), (
        f"{int(bad.sum())} near-tie p-values differ, margins "
        f"{sorted(set(np.round(diff[bad] * (n_max + 1), 3)))} rank steps")


# ---------------------------------------------------------------------------
# path parity with the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,k", [("sliding", 3), ("sliding", 7),
                                    ("sliding", 1), ("grow", 3)])
def test_engine_matches_jax_engine(mode, k):
    sliding = mode == "sliding"
    kw = dict(n_sessions=S, capacity=CAP if sliding else 8, dim=DIM, k=k,
              window=W if sliding else None)
    xs, ys, taus, active = _traffic(k + 10 * sliding)
    jeng = JaxEngine(**kw, donate=False)
    teng = RegressionServingEngine(**kw, device="cpu")
    jstate = jeng.init_state()
    tstate = convert.reg_state_from_numpy(
        [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)], "cpu")
    jps, tps = [], []
    for lo, hi in [(0, 7), (7, 8), (8, 35), (35, T)]:
        jstate, jp = jeng.observe_many(
            jstate, jnp.asarray(xs[lo:hi]), jnp.asarray(ys[lo:hi]),
            jnp.asarray(taus[lo:hi]), jnp.asarray(active[lo:hi]))
        tstate, tp = teng.observe_many(tstate, xs[lo:hi], ys[lo:hi],
                                       taus[lo:hi], active[lo:hi])
        jps.append(np.asarray(jp))
        tps.append(tp.numpy())
    tp, jp = np.concatenate(tps), np.concatenate(jps)
    _assert_pvalues_close(tp, jp, CAP)
    assert np.isnan(tp[~active]).all() and not np.isnan(tp[active]).any()
    assert teng.capacity == jeng.capacity
    if sliding:
        assert (tstate.head > 0).any()  # the rings wrapped
    else:
        assert teng.capacity > 8  # capacity doubled
    jleaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)]
    for i, (g, w) in enumerate(zip(convert.reg_state_to_numpy(tstate),
                                   jleaves)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        if i in INT_LEAVES:
            np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                       err_msg=f"leaf {i}")

    rng = np.random.default_rng(7)
    Xq = rng.standard_normal((S, 6, DIM)).astype(np.float32)
    for q in (Xq, Xq[0]):  # per-tenant queries and a shared batch
        got = teng.intervals(tstate, q, epsilon=EPS).numpy()
        want = np.asarray(jeng.intervals(jstate, jnp.asarray(q),
                                         epsilon=EPS))
        assert got.shape == want.shape == (S, 6, 2)
        ok = _ill_rows(tstate, np.broadcast_to(q, Xq.shape), k) == 0
        assert ok.mean() >= 0.4  # k == 1 flags its mutual nearest pairs
        np.testing.assert_array_equal(np.isnan(got[ok]), np.isnan(want[ok]))
        np.testing.assert_allclose(got[ok], want[ok], atol=1e-4, rtol=1e-4)
    tq = np.linspace(-4.0, 4.0, 9).astype(np.float32) + 0.0137
    _assert_pvalues_close(
        teng.pvalues(tstate, Xq, tq).numpy(),
        np.asarray(jeng.pvalues(jstate, jnp.asarray(Xq), jnp.asarray(tq))),
        CAP)


def test_convert_round_trip_and_meta():
    eng = _engine()
    xs, ys, taus, active = _traffic(6, T=30)
    state, _ = eng.observe_many(eng.init_state(), xs, ys, taus, active)
    leaves = convert.reg_state_to_numpy(state)
    back = convert.reg_state_to_numpy(convert.reg_state_from_numpy(leaves,
                                                                   "cpu"))
    for a, b in zip(leaves, back):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    eng2 = RegressionServingEngine.from_meta(eng.meta(), device="cpu")
    assert eng2.meta() == eng.meta()
    jmeta = JaxEngine.from_meta(eng.meta()).meta()
    assert RegressionServingEngine.from_meta(jmeta, device="cpu").meta() == \
        eng.meta()
    with pytest.raises(ValueError, match="regression"):
        RegressionServingEngine.from_meta({**eng.meta(), "mode": "x"})


# ---------------------------------------------------------------------------
# exactness inside the port, bitwise
# ---------------------------------------------------------------------------


def _surviving_window(xs, ys, active, w=W):
    """Each tenant's last ``w`` active points, in arrival order."""
    surv = [np.flatnonzero(active[:, s])[-w:] for s in range(xs.shape[1])]
    assert all(len(t) == w for t in surv)
    pick = lambda a: np.stack([a[surv[s], s] for s in range(a.shape[1])], 1)  # noqa
    return pick(xs), pick(ys)


@pytest.mark.parametrize("kind,k", [("linear", 3), ("ties", 3),
                                    ("ties", 7), ("linear", 1)])
def test_state_view_equals_fit_after_sliding(kind, k):
    """Eviction == refit: the streamed statistics of every tenant equal
    the port's ``fit`` on its surviving window, bit for bit."""
    xs, ys, taus, active = _traffic(20 + k, kind=kind)
    eng = _engine(k=k)
    state, _ = eng.observe_many(eng.init_state(), xs, ys, taus, active)
    assert int(state.head.max()) > 0
    wx, wy = _surviving_window(xs, ys, active)
    view = rstream.state_view(state, k=k)
    fit = reg.fit(torch.from_numpy(np.ascontiguousarray(wx.swapaxes(0, 1))),
                  torch.from_numpy(np.ascontiguousarray(wy.T)), k=k)
    for name in ("X", "y", "a_prime", "kth_dist", "kth_label"):
        assert torch.equal(getattr(view, name)[:, :W], getattr(fit, name)), \
            name


@pytest.mark.parametrize("kind", ["linear", "ties"])
def test_lists_after_to_linear_equal_fresh_engine(kind):
    """The repaired lists equal those of a fresh engine fed only the
    surviving window; arrival ids compared relative to the oldest live
    id (the absolute counters differ by the evicted arrivals)."""
    xs, ys, taus, active = _traffic(31, kind=kind)
    eng = _engine()
    state, _ = eng.observe_many(eng.init_state(), xs, ys, taus, active)
    wx, wy = _surviving_window(xs, ys, active)
    fresh = _engine()
    ref_state, _ = fresh.observe_many(fresh.init_state(), wx, wy,
                                      np.zeros(wy.shape, np.float32))
    a, b = rstream.to_linear(state), rstream.to_linear(ref_state)
    for name in ("X", "y", "D", "nbr_d", "nbr_y", "n", "head", "wrap"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    rel = lambda s: torch.where(s.nbr_d < 1e29,  # noqa: E731
                                s.nbr_a - s.aid[:, :1, None], 0)
    assert torch.equal(rel(a), rel(b))
    assert torch.equal(a.aid[:, :W] - a.aid[:, :1],
                       b.aid[:, :W] - b.aid[:, :1])
    # the lists are fit's lists on the window
    knn_d, labels = reg.fit_lists(
        torch.from_numpy(np.ascontiguousarray(wx.swapaxes(0, 1))),
        torch.from_numpy(np.ascontiguousarray(wy.T)), k=K)
    assert torch.equal(a.nbr_d[:, :W], knn_d)
    assert torch.equal(a.nbr_y[:, :W], labels)


@pytest.mark.parametrize("window", [W, None])
def test_observe_many_chunk_equals_per_tick(window):
    xs, ys, taus, active = _traffic(12)
    kw = dict(window=window, capacity=CAP if window else 8)
    eng = _engine(**kw)
    state, _ = eng.observe_many(eng.init_state(), xs[:30], ys[:30],
                                taus[:30], active[:30])
    a, b = state.clone(), state.clone()
    eng_a, eng_b = _engine(**kw), _engine(**kw)
    eng_a.capacity = eng_b.capacity = state.capacity
    a, pa = eng_a.observe_many(a, xs[30:], ys[30:], taus[30:], active[30:])
    pb = []
    for t in range(30, T):
        b, p = eng_b.observe(b, xs[t], ys[t], taus[t], active[t])
        pb.append(p)
    pb = torch.stack(pb)
    assert torch.equal(pa.isnan(), pb.isnan())
    assert torch.equal(torch.nan_to_num(pa), torch.nan_to_num(pb))
    _assert_equal_state(a, b)


@pytest.mark.parametrize("window", [W, None])
def test_engine_equals_one_tenant_engines(window):
    xs, ys, taus, active = _traffic(14, kind="ties")
    kw = dict(window=window, capacity=CAP if window else 8)
    eng = _engine(**kw)
    state, got = eng.observe_many(eng.init_state(), xs, ys, taus, active)
    for s in range(S):
        one = _engine(n_sessions=1, **kw)
        st1, want = one.observe_many(one.init_state(), xs[:, s:s + 1],
                                     ys[:, s:s + 1], taus[:, s:s + 1],
                                     active[:, s:s + 1])
        assert torch.equal(got[:, s].isnan(), want[:, 0].isnan())
        assert torch.equal(torch.nan_to_num(got[:, s]),
                           torch.nan_to_num(want[:, 0]))
        for la, lb in zip(state.leaves(), st1.leaves()):
            assert torch.equal(la[s], lb[0])


@pytest.mark.parametrize("kind", ["linear", "ties"])
def test_served_intervals_equal_intervals_optimized(kind):
    """Served reads == ``intervals_optimized`` / ``pvalues_optimized``
    on each tenant's refit window, bit for bit."""
    xs, ys, taus, active = _traffic(41, kind=kind)
    eng = _engine()
    state, _ = eng.observe_many(eng.init_state(), xs, ys, taus, active)
    wx, wy = _surviving_window(xs, ys, active)
    Xq = np.random.default_rng(3).standard_normal((S, 7, DIM)).astype(
        np.float32)
    iv = eng.intervals(state, Xq, epsilon=EPS)
    tq = torch.linspace(-4.0, 4.0, 9) + 0.0137
    pv = eng.pvalues(state, Xq, tq)
    for s in range(S):
        fit = reg.fit(torch.from_numpy(wx[:, s].copy()),
                      torch.from_numpy(wy[:, s].copy()), k=K)
        q = torch.from_numpy(Xq[s])
        want = reg.intervals_optimized(fit, q, k=K, epsilon=EPS)
        assert torch.equal(iv[s].isnan(), want.isnan())
        assert torch.equal(torch.nan_to_num(iv[s]), torch.nan_to_num(want))
        assert torch.equal(pv[s], reg.pvalues_optimized(fit, q, tq, k=K))


@pytest.mark.parametrize("k", [1, 3, 7])
def test_intervals_optimized_equal_standard(k):
    """The paper's claim, in the port: the O(n) update gives the scores
    of the O(n^2) recomputation. The two round differently, so, as in the
    JAX package's test, p-values agree up to measure-zero rank flips and
    the interval endpoints to f32 precision."""
    rng = np.random.default_rng(50 + k)
    n, m = 48, 16
    X = rng.standard_normal((n, DIM)).astype(np.float32)
    y = (X @ rng.standard_normal(DIM) + 0.1 * rng.standard_normal(n)).astype(
        np.float32)
    Xt = torch.from_numpy(rng.standard_normal((m, DIM)).astype(np.float32))
    X, y = torch.from_numpy(X), torch.from_numpy(y)
    tq = torch.linspace(float(y.min()) - 5, float(y.max()) + 5, 41) + 0.0137
    fit = reg.fit(X, y, k=k)
    p_std = reg.pvalues_standard(X, y, Xt, tq, k=k)
    p_opt = reg.pvalues_optimized(fit, Xt, tq, k=k)
    d = (p_std - p_opt).abs()
    assert float((d > 1e-6).float().mean()) <= 0.02
    assert float(d.max()) <= 2.5 / (n + 1)
    iv_std = reg.intervals_standard(X, y, Xt, k=k, epsilon=EPS)
    iv_opt = reg.intervals_optimized(fit, Xt, k=k, epsilon=EPS)
    # rows with an ill-conditioned critical point: at k == 1 the standard
    # path's a_i + a of a mutual nearest pair is exactly 0, the optimized
    # path's (a'_i + y_nn) - y_i is 0 or one ulp
    a = reg.ab_optimized(fit, Xt, k=k)[2]
    ok = torch.from_numpy(ill_conditioned(
        reg._dists(Xt, X), fit.kth_dist, torch.ones(n, dtype=torch.bool),
        fit.a_prime, fit.kth_label, a, k).sum(-1) == 0)
    assert float(ok.float().mean()) >= 0.25
    assert torch.equal(iv_std[ok].isnan(), iv_opt[ok].isnan())
    torch.testing.assert_close(torch.nan_to_num(iv_opt[ok]),
                               torch.nan_to_num(iv_std[ok]), atol=1e-4,
                               rtol=1e-5)


def test_arrival_id_wraparound_is_harmless():
    """Arrival ids starting at int32 max - 4 overflow within a few ticks;
    every id comparison is a wraparound difference from the oldest live
    id, so the shifted twin evicts and learns exactly like the original
    (tie-heavy data, so the id-based tie-breaks fire)."""
    xs, ys, taus, active = _traffic(8, kind="ties", ragged=False)
    eng_a, eng_b = _engine(), _engine()
    a, _ = eng_a.observe_many(eng_a.init_state(), xs[:W], ys[:W], taus[:W])
    b = a.clone()
    off = 2**31 - 1 - 4 - int(a.aid.min())  # oldest id -> int32 max - 4
    live = b.nbr_d < 1e29
    b.aid = (b.aid.long() + off).to(torch.int32)
    b.nbr_a = torch.where(live, (b.nbr_a.long() + off).to(torch.int32), 0)
    # the window's ids run from int32 max - 4 across the overflow
    assert int(b.aid.max()) == 2**31 - 1 and bool((b.aid < 0).any())
    a, pa = eng_a.observe_many(a, xs[W:], ys[W:], taus[W:])
    b, pb = eng_b.observe_many(b, xs[W:], ys[W:], taus[W:])
    assert torch.equal(pa, pb)
    for name in ("X", "y", "D", "nbr_d", "nbr_y", "n", "head"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_stream_observe_evict_equals_fit():
    """The stream-level operations: ``from_fit`` then interleaved
    ``evict_oldest`` / ``observe`` keep the statistics equal to ``fit``
    on the current window."""
    rng = np.random.default_rng(4)
    Tn, cap, k = 30, 24, 3
    X = rng.integers(0, 2, (2, Tn, DIM)).astype(np.float32)
    y = rng.integers(0, 3, (2, Tn)).astype(np.float32)
    st = rstream.from_fit(X[:, :16], y[:, :16], k=k, capacity=cap,
                          device="cpu")
    lo = 0
    for t in range(16, Tn):
        st = rstream.evict_oldest(st, k=k)
        lo += 1
        st, d_row = rstream.observe(st, torch.from_numpy(X[:, t].copy()),
                                    torch.from_numpy(y[:, t].copy()), k=k)
        assert int((d_row < 1e29).sum()) == 2 * 15
    fit = reg.fit(torch.from_numpy(X[:, lo:Tn].copy()),
                  torch.from_numpy(y[:, lo:Tn].copy()), k=k)
    view = rstream.state_view(st, k=k)
    for name in ("X", "y", "a_prime", "kth_dist", "kth_label"):
        assert torch.equal(getattr(view, name)[:, :16], getattr(fit, name))


def test_inactive_lanes_and_donate_false_keep_state():
    xs, ys, taus, _ = _traffic(15)
    eng = _engine()
    state, _ = eng.observe_many(eng.init_state(), xs[:40], ys[:40],
                                taus[:40])
    before = state.clone()
    keep = _engine(donate=False)
    _, p = keep.observe_many(state, xs[40:], ys[40:], taus[40:])
    _assert_equal_state(state, before)
    assert not p.isnan().any()
    off = np.zeros((T - 40, S), bool)
    state, p = eng.observe_many(state, xs[40:], ys[40:], taus[40:], off)
    assert p.isnan().all()
    _assert_equal_state(state, before)


def test_session_grow_keeps_window_and_engine_validates():
    xs, ys, taus, _ = _traffic(16, ragged=False)
    st = rsess.init(16, DIM, K, n_sessions=S, device="cpu")
    for t in range(12):
        st, _ = rsess._observe(st, torch.from_numpy(xs[t]),
                               torch.from_numpy(ys[t]),
                               torch.from_numpy(taus[t]), k=K)
    big = rsess.grow(st)
    assert big.capacity == 32 and int(big.wrap[0]) == 32
    a, b = rstream.to_linear(st), rstream.to_linear(big)
    assert torch.equal(b.nbr_d[:, :16], a.nbr_d)
    assert torch.equal(b.D[:, :16, :16], a.D)
    with pytest.raises(ValueError, match="window"):
        _engine(window=CAP + 1)
    with pytest.raises(ValueError, match="capacity"):
        _engine(capacity=2, window=None)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        eng = RegressionServingEngine(n_sessions=1, capacity=8, dim=2, k=2)
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            RegressionServingEngine(n_sessions=1, capacity=8, dim=2, k=2)
