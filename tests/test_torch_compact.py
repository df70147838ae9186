"""The port's compact layout: the ring tick's bit-oracle, re-proved in torch.

Inside the port, bitwise (``torch.equal``): both engines with
``layout="ring"`` and ``layout="compact"`` fed the same traffic give the
same p-values (NaN on the same gated lanes) and, after ``to_linear``, the
same state leaf for leaf; ``predict`` / ``intervals`` on the two states
agree bit for bit. The cases cross the ring's wrap seam, hold exact
distance ties (points on an integer grid), gate lanes off and run the
window block (``wmax``) of a larger capacity.

Against the JAX package: the port's compact engines and the JAX engines
with ``layout="compact"`` start from one state and get the same numpy
traffic; integer leaves exact, float leaves and p-values within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.regression import RegressionServingEngine as JaxRegEngine  # noqa: E402,E501
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.core import online  # noqa: E402
from repro_torch.regression import RegressionServingEngine  # noqa: E402
from repro_torch.regression import stream as rstream  # noqa: E402
from repro_torch.serving import ServingEngine, convert  # noqa: E402
from repro_torch.serving import session as sm  # noqa: E402

S, DIM = 4, 4


def _traffic(seed, T, kind, ties, act_share=0.25, S=S, dim=DIM):
    """``xs (T, S, dim)``, labels (int32 classes or float32 reg labels),
    taus and an ``active`` gate with about ``act_share`` lanes off. With
    ``ties`` the points sit on a {0, 1} grid, so many distances tie."""
    rng = np.random.default_rng(seed)
    if ties:
        xs = rng.integers(0, 2, (T, S, dim)).astype(np.float32)
    else:
        xs = rng.standard_normal((T, S, dim)).astype(np.float32)
    if kind == "class":
        ys = rng.integers(0, 2, (T, S)).astype(np.int32)
        xs += ys[..., None]
    elif ties:
        ys = rng.integers(0, 3, (T, S)).astype(np.float32)
    else:
        w = rng.standard_normal((S, dim)).astype(np.float32)
        ys = (np.einsum("sd,tsd->ts", w, xs)
              + 0.1 * rng.standard_normal((T, S))).astype(np.float32)
    taus = rng.random((T, S)).astype(np.float32)
    active = rng.random((T, S)) >= act_share
    return xs, ys, taus, active


def _engines(kind, **kw):
    make = ServingEngine if kind == "class" else RegressionServingEngine
    if kind == "class":
        kw.setdefault("n_labels", 2)
    return (make(**kw, layout="ring", device="cpu"),
            make(**kw, layout="compact", device="cpu"))


def _linear(kind, state):
    return (sm.to_linear(state) if kind == "class"
            else rstream.to_linear(state))


def _assert_states_equal(a, b):
    for i, (la, lb) in enumerate(zip(a.leaves(), b.leaves())):
        assert torch.equal(la, lb), f"leaf {i}"


# (seed, k, window, capacity, ties, T): the window crosses its seam at
# least twice; capacity > window runs the [:window] block (wmax)
CASES = [(0, 3, 12, 12, False, 40), (1, 5, 10, 16, True, 37),
         (2, 1, 7, 7, True, 30), (3, 4, 24, 24, False, 62),
         (4, 2, 9, 20, True, 33)]


@pytest.mark.parametrize("kind", ["class", "reg"])
@pytest.mark.parametrize("seed,k,window,cap,ties,T", CASES)
def test_ring_equals_compact_bitwise(kind, seed, k, window, cap, ties, T):
    ring, comp = _engines(kind, n_sessions=S, capacity=cap, dim=DIM, k=k,
                          window=window)
    xs, ys, taus, active = _traffic(seed, T, kind, ties)
    a, b = ring.init_state(), comp.init_state()
    pa, pb = [], []
    for lo, hi in [(0, 5), (5, 6), (6, T)]:  # a chunk of one among them
        a, p = ring.observe_many(a, xs[lo:hi], ys[lo:hi], taus[lo:hi],
                                 active[lo:hi])
        pa.append(p)
        b, p = comp.observe_many(b, xs[lo:hi], ys[lo:hi], taus[lo:hi],
                                 active[lo:hi])
        pb.append(p)
    pa, pb = torch.cat(pa), torch.cat(pb)
    assert torch.equal(pa.isnan(), torch.from_numpy(~active))
    assert torch.equal(torch.nan_to_num(pa, nan=-1.0),
                       torch.nan_to_num(pb, nan=-1.0))
    assert int(a.head.max()) > 0 and int(b.head.max()) == 0
    _assert_states_equal(_linear(kind, a), _linear(kind, b))
    Xq = np.random.default_rng(seed + 100).integers(
        0, 2, (S, 5, DIM)).astype(np.float32)
    if kind == "class":
        assert torch.equal(ring.predict(a, Xq), comp.predict(b, Xq))
    else:
        ia = ring.intervals(a, Xq, epsilon=0.2)
        ib = comp.intervals(b, Xq, epsilon=0.2)
        assert torch.equal(ia.isnan(), ib.isnan())
        assert torch.equal(torch.nan_to_num(ia), torch.nan_to_num(ib))


@pytest.mark.parametrize("kind", ["class", "reg"])
def test_compact_grow_mode_equals_ring(kind):
    """Without a window the compact tick is a pure observe; capacity
    doubles under load in both layouts alike."""
    ring, comp = _engines(kind, n_sessions=S, capacity=4, dim=DIM, k=2)
    xs, ys, taus, active = _traffic(9, 20, kind, ties=True)
    a, pa = ring.observe_many(ring.init_state(), xs, ys, taus, active)
    b, pb = comp.observe_many(comp.init_state(), xs, ys, taus, active)
    assert ring.capacity == comp.capacity > 4
    assert torch.equal(torch.nan_to_num(pa, nan=-1.0),
                       torch.nan_to_num(pb, nan=-1.0))
    _assert_states_equal(a, b)


@pytest.mark.parametrize("kind", ["class", "reg"])
def test_observe_sliding_is_the_all_active_tick(kind):
    from repro_torch.regression import session as rsess

    mod = sm if kind == "class" else rsess
    ring, _ = _engines(kind, n_sessions=S, capacity=8, dim=DIM, k=2,
                       window=8)
    xs, ys, taus, _ = _traffic(11, 19, kind, ties=True, act_share=0.0)
    a, b = ring.init_state(), ring.init_state()
    win = torch.full((S,), 8, dtype=torch.int32)
    for t in range(19):
        cast = torch.int32 if kind == "class" else torch.float32
        x, y = torch.from_numpy(xs[t]), torch.from_numpy(ys[t]).to(cast)
        tau = torch.from_numpy(taus[t])
        a, p = mod._observe_sliding(a, x, y, tau, win, k=2)
        b, q = ring.observe(b, xs[t], ys[t], taus[t])
        assert torch.equal(p, q)
    _assert_states_equal(a, b)


def test_cshift_zero_is_identity_and_one_drops_the_head():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((3, 5, 2)).astype(np.float32))
    a[0, 1, 0] = -0.0
    s = torch.tensor([0, 1, 0], dtype=torch.int32)
    out = online.cshift(a, s, 7.0)
    for i in (0, 2):  # bitwise, signed zero included
        assert torch.equal(out[i].view(torch.int32), a[i].view(torch.int32))
    assert torch.equal(out[1, :4], a[1, 1:])
    assert (out[1, 4] == 7.0).all()
    D = torch.from_numpy(rng.standard_normal((3, 4, 4)).astype(np.float32))
    D2 = online.cshift2(D, s, 9.0)
    assert torch.equal(D2[0], D[0]) and torch.equal(D2[2], D[2])
    assert torch.equal(D2[1, :3, :3], D[1, 1:, 1:])
    assert (D2[1, 3] == 9.0).all() and (D2[1, :, 3] == 9.0).all()
    b = torch.tensor([[True, False], [False, True]])
    assert torch.equal(online.cshift(b, torch.tensor([0, 1]), False),
                       torch.tensor([[True, False], [True, False]]))


def test_unknown_layout_raises():
    for make in (ServingEngine, RegressionServingEngine):
        with pytest.raises(ValueError, match="layout"):
            make(n_sessions=1, capacity=8, dim=2, k=2, window=4,
                 layout="bogus", device="cpu")
    eng = ServingEngine(n_sessions=1, capacity=8, dim=2, k=2, window=4,
                        layout="compact", device="cpu")
    assert "layout" not in eng.meta()  # as the JAX engine's meta


@pytest.mark.parametrize("ties", [False, True])
def test_evict_oldest_equals_refit_of_survivors(ties):
    """``_evict_oldest`` on a wrapped ring (a head advance and the plain
    repair) == a fresh session fed the survivors, bitwise after
    ``to_linear``; repeated, so the head crosses the seam."""
    cap, k, T = 10, 3, 23
    eng = ServingEngine(n_sessions=S, capacity=cap, dim=DIM, k=k,
                        window=cap, device="cpu")
    xs, ys, taus, _ = _traffic(5 + ties, T, "class", ties, act_share=0.0)
    state, _ = eng.observe_many(eng.init_state(), xs, ys, taus)
    for drop in range(1, 5):
        state = sm._evict_oldest(state, k=k)
        fresh = ServingEngine(n_sessions=S, capacity=cap, dim=DIM, k=k,
                              window=cap, device="cpu")
        lo = T - cap + drop
        want, _ = fresh.observe_many(fresh.init_state(), xs[lo:],
                                     ys[lo:], taus[lo:])
        assert int(state.n.min()) == cap - drop
        _assert_states_equal(sm.to_linear(state), sm.to_linear(want))


def _pvalues_close(got, want):
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["class", "reg"])
def test_compact_engine_matches_jax_compact_engine(kind):
    """The port's compact engine against the JAX ``layout="compact"``
    engine: same start state, same numpy traffic; integer leaves exact,
    float leaves and p-values within 1e-5."""
    cap, window, k, T = 16, 12, 3, 36
    kw = dict(n_sessions=S, capacity=cap, dim=DIM, k=k, window=window)
    xs, ys, taus, active = _traffic(21, T, kind, ties=False)
    if kind == "class":
        kw["n_labels"] = 2
        jeng = JaxEngine(**kw, layout="compact", donate=False)
        teng = ServingEngine(**kw, layout="compact", device="cpu")
        to_t, to_np = convert.session_from_numpy, convert.session_to_numpy
        ints = (1, 3, 5, 6, 7)
    else:
        jeng = JaxRegEngine(**kw, layout="compact", donate=False)
        teng = RegressionServingEngine(**kw, layout="compact",
                                       device="cpu")
        to_t = convert.reg_state_from_numpy
        to_np = convert.reg_state_to_numpy
        ints = (5, 6, 7, 8, 9)
    jstate = jeng.init_state()
    tstate = to_t([np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)],
                  "cpu")
    jstate, jp = jeng.observe_many(jstate, jnp.asarray(xs), jnp.asarray(ys),
                                   jnp.asarray(taus), jnp.asarray(active))
    tstate, tp = teng.observe_many(tstate, xs, ys, taus, active)
    _pvalues_close(tp.numpy(), np.asarray(jp))
    jleaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)]
    for i, (g, w) in enumerate(zip(to_np(tstate), jleaves)):
        assert g.shape == w.shape, i
        if i in ints:
            np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                       err_msg=f"leaf {i}")
    assert int(tstate.head.max()) == 0 and int(tstate.n.min()) == window
