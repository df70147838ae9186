"""Exactness properties re-proved inside the port, bit for bit.

* eviction == refit: a sliding engine's state after ``to_linear`` equals,
  leaf for leaf, a fresh engine fed each tenant's surviving window;
* chunking: ``observe_many`` over T ticks == T calls of ``observe``;
* engine == sequential per-tenant streams: each tenant's p-values equal
  ``core.online.run_stream`` (grow mode) or a one-tenant engine (sliding).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import online  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import session as sm  # noqa: E402

S, DIM, K, CAP, W, T = 3, 4, 3, 16, 12, 40


def _traffic(seed, kind="gauss", T=T, S=S, ragged=True):
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, 2, (T, S)).astype(np.int32)
    if kind == "binary":  # many exactly equal distances
        xs = rng.integers(0, 2, (T, S, DIM)).astype(np.float32)
    else:
        xs = (rng.standard_normal((T, S, DIM)) + ys[..., None]).astype(
            np.float32)
    taus = rng.random((T, S)).astype(np.float32)
    active = rng.random((T, S)) < 0.8 if ragged else np.ones((T, S), bool)
    return xs, ys, taus, active


def _engine(**kw):
    args = dict(n_sessions=S, capacity=CAP, dim=DIM, k=K, window=W,
                device="cpu")
    args.update(kw)
    return ServingEngine(**args)


def _assert_equal_state(a, b):
    for i, (la, lb) in enumerate(zip(a.leaves(), b.leaves())):
        assert torch.equal(la, lb), f"leaf {i}"


@pytest.mark.parametrize("kind", ["gauss", "binary"])
def test_eviction_equals_refit(kind):
    xs, ys, taus, active = _traffic(11, kind)
    eng = _engine()
    state, _ = eng.observe_many(eng.init_state(), xs, ys, taus, active)
    assert int(state.head.max()) > 0  # evictions advanced the ring
    # each tenant's surviving window: its last W active points, in order
    surv = [np.flatnonzero(active[:, s])[-W:] for s in range(S)]
    assert all(len(t) == W for t in surv)
    pick = lambda a: np.stack([a[surv[s], s] for s in range(S)], 1)  # noqa
    fresh = _engine()
    ref, _ = fresh.observe_many(fresh.init_state(), pick(xs), pick(ys),
                                pick(taus))
    _assert_equal_state(sm.to_linear(state), sm.to_linear(ref))


@pytest.mark.parametrize("window", [W, None])
def test_observe_many_chunk_equals_per_tick(window):
    xs, ys, taus, active = _traffic(12)
    kw = dict(window=window, capacity=CAP if window else 8)
    eng = _engine(**kw)
    state, _ = eng.observe_many(eng.init_state(), xs[:20], ys[:20],
                                taus[:20], active[:20])
    a, b = state.clone(), state.clone()
    eng_a, eng_b = _engine(**kw), _engine(**kw)
    eng_a.capacity = eng_b.capacity = state.capacity
    a, pa = eng_a.observe_many(a, xs[20:], ys[20:], taus[20:], active[20:])
    pb = []
    for t in range(20, T):
        b, p = eng_b.observe(b, xs[t], ys[t], taus[t], active[t])
        pb.append(p)
    assert torch.equal(pa.isnan(), torch.stack(pb).isnan())
    assert torch.equal(torch.nan_to_num(pa), torch.nan_to_num(
        torch.stack(pb)))
    _assert_equal_state(a, b)


def test_grow_engine_equals_sequential_run_stream():
    xs, ys, taus, _ = _traffic(13, ragged=False)
    eng = _engine(window=None, capacity=4)
    state, got = eng.observe_many(eng.init_state(), xs[:9], ys[:9], taus[:9])
    state, more = eng.observe_many(state, xs[9:], ys[9:], taus[9:])
    got = torch.cat([got, more])
    assert state.capacity >= T
    for s in range(S):
        want, _ = online.run_stream(xs[:, s], ys[:, s], k=K, taus=taus[:, s],
                                    device="cpu")
        assert torch.equal(got[:, s], want)


def test_session_observe_equals_run_stream():
    """``session._observe`` (price, learn, record D) gives each tenant the
    p-values of its own stream, and D holds the observed distances."""
    xs, ys, taus, _ = _traffic(16, T=20, ragged=False)
    sess = sm.init(32, DIM, K, n_sessions=S, device="cpu")
    got = []
    for t in range(20):
        sess, p = sm._observe(sess, torch.from_numpy(xs[t]),
                              torch.from_numpy(ys[t]),
                              torch.from_numpy(taus[t]), k=K)
        got.append(p)
    got = torch.stack(got)
    for s in range(S):
        want, _ = online.run_stream(xs[:, s], ys[:, s], k=K, taus=taus[:, s],
                                    capacity=32, device="cpu")
        assert torch.equal(got[:, s], want)
    D = sess.D[:, :20, :20]
    assert torch.equal(D, D.transpose(1, 2))
    assert bool((D.diagonal(dim1=1, dim2=2) == online.BIG).all())


def test_sliding_engine_equals_one_tenant_engines():
    xs, ys, taus, active = _traffic(14)
    eng = _engine()
    _, got = eng.observe_many(eng.init_state(), xs, ys, taus, active)
    for s in range(S):
        one = _engine(n_sessions=1)
        _, want = one.observe_many(one.init_state(), xs[:, s:s + 1],
                                   ys[:, s:s + 1], taus[:, s:s + 1],
                                   active[:, s:s + 1])
        assert torch.equal(got[:, s].isnan(), want[:, 0].isnan())
        assert torch.equal(torch.nan_to_num(got[:, s]),
                           torch.nan_to_num(want[:, 0]))


def test_inactive_lanes_and_donate_false_keep_state():
    xs, ys, taus, _ = _traffic(15)
    eng = _engine()
    state, _ = eng.observe_many(eng.init_state(), xs[:30], ys[:30],
                                taus[:30])
    before = state.clone()
    keep = _engine(donate=False)
    _, p = keep.observe_many(state, xs[30:], ys[30:], taus[30:])
    _assert_equal_state(state, before)  # the caller's state untouched
    assert not p.isnan().any()
    off = np.zeros((T - 30, S), bool)
    state, p = eng.observe_many(state, xs[30:], ys[30:], taus[30:], off)
    assert p.isnan().all()
    _assert_equal_state(state, before)
