"""The registry's ``knn_regression`` and the regression leftovers it needs
(``stream.evict``, ``icp_intervals``, blocked ``fit`` / ``ab_standard``),
against the JAX package and bitwise inside the port.

Parity: the same numpy inputs go through the JAX function and the port's;
integer leaves (``n``, ``head``, ``wrap``, ``aid``, ``nbr_a``) exactly,
float leaves within 1e-5, intervals within 1e-4 on query rows without an
ill-conditioned critical point (``test_torch_regression_kernels.
ill_conditioned``). Exactness inside the port: ``evict(i)`` == ``from_fit``
on the survivors in arrival order, bitwise on every leaf, the arrival ids
compared after the order-preserving relabelling (``from_fit`` numbers
from 0); the JAX twin of that proof depends on the host (ROADMAP Queue
3), so it stands here in torch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper import CONFIG as JCONFIG  # noqa: E402
from repro.configs.paper import PaperConfig as JPaperConfig  # noqa: E402
from repro.core import regression as jreg  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.regression import stream as jstream  # noqa: E402
from repro.serving import registry as jregistry  # noqa: E402
from repro_torch.configs.paper import CONFIG, PaperConfig  # noqa: E402
from repro_torch.core import regression as reg  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.regression import session as rsess  # noqa: E402
from repro_torch.regression import stream as rstream  # noqa: E402
from repro_torch.serving import convert, registry  # noqa: E402
from test_torch_regression_kernels import ill_conditioned  # noqa: E402

DIM, K, EPS = 5, 3, 0.1234567  # eps off every rank boundary
INT_LEAVES = (5, 6, 7, 8, 9)  # n, head, aid, wrap, nbr_a


def _data(seed, n, kind="linear", dim=DIM):
    """``(X (n, dim), y (n,))`` f32: linear labels, or a {0, 1} grid with
    integer labels (``kind="ties"``: many equal distances and labels)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return (rng.integers(0, 2, (n, dim)).astype(np.float32),
                rng.integers(0, 3, n).astype(np.float32))
    X = rng.standard_normal((n, dim)).astype(np.float32)
    y = (X @ rng.standard_normal(dim)
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return X, y


def _wrapped(X, y, n0, cap, k, S=1):
    """A port state over ``S`` tenants, ``from_fit`` on the first ``n0``
    points of each, then one ``evict_oldest`` + ``observe`` per further
    point: the ring wraps. Returns the state and each tenant's window (its
    arrival order)."""
    X = np.broadcast_to(X, (S,) + X.shape).copy()
    y = np.broadcast_to(y, (S,) + y.shape).copy()
    st = rstream.from_fit(X[:, :n0], y[:, :n0], k=k, capacity=cap,
                          device="cpu")
    lo = 0
    for t in range(n0, X.shape[1]):
        st = rstream.evict_oldest(st, k=k)
        lo += 1
        st, _ = rstream.observe(st, torch.from_numpy(X[:, t].copy()),
                                torch.from_numpy(y[:, t].copy()), k=k)
    return st, X[:, lo:], y[:, lo:]


def _relabel(st):
    """Arrival ids as ranks among each tenant's live ids: ``(aid,
    nbr_a)`` with ``aid`` 0, 1, ... on the live rows and ``nbr_a`` the
    rank of each live neighbour's id (0 where the list is BIG)."""
    aid, nbr_a = torch.zeros_like(st.aid), torch.zeros_like(st.nbr_a)
    for s in range(st.n.shape[0]):
        n = int(st.n[s])
        live = st.aid[s, :n]
        assert bool((live[1:] > live[:-1]).all()), "ids in arrival order"
        aid[s, :n] = torch.arange(n, dtype=torch.int32)
        ok = st.nbr_d[s] < 1e29
        rank = torch.searchsorted(live, st.nbr_a[s].contiguous())
        assert torch.equal(live[rank.clamp(max=n - 1)][ok], st.nbr_a[s][ok])
        nbr_a[s] = torch.where(ok, rank.to(torch.int32), 0)
    return aid, nbr_a


def _assert_same_window(got, want):
    for name in ("X", "y", "D", "nbr_d", "nbr_y", "n", "head", "wrap"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for a, b in zip(_relabel(got), _relabel(want)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# stream.evict
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["linear", "ties"])
@pytest.mark.parametrize("where", ["head", "middle", "last"])
def test_evict_equals_from_fit_on_the_survivors_bitwise(kind, where):
    """On a wrapped ring, two tenants each forgetting a different rank."""
    cap, n0, T = 24, 20, 31
    X, y = _data(3 + (kind == "ties"), T, kind)
    st, wx, wy = _wrapped(X, y, n0, cap, K, S=2)
    assert bool((st.head > 0).all()) and int(st.n[0]) == n0
    i = {"head": [0, 1], "middle": [7, 12], "last": [n0 - 1, n0 - 2]}[where]
    got = rstream.evict(st.clone(), torch.tensor(i, dtype=torch.int32), k=K)
    keep = [np.delete(np.arange(n0), i[s]) for s in range(2)]
    want = rstream.from_fit(
        np.stack([wx[s, keep[s]] for s in range(2)]),
        np.stack([wy[s, keep[s]] for s in range(2)]), k=K, capacity=cap,
        device="cpu")
    _assert_same_window(got, want)


def test_evict_then_observe_keeps_the_refit_equality():
    """Arbitrary evictions interleaved with learning: the state stays
    the refit of its window, bitwise."""
    X, y = _data(9, 40, "ties")
    st = rstream.from_fit(X[None, :16], y[None, :16], k=K, capacity=32,
                          device="cpu")
    window = list(range(16))
    rng = np.random.default_rng(0)
    for t in range(16, 28):
        i = int(rng.integers(0, len(window)))
        st = rstream.evict(st, i, k=K)
        del window[i]
        st, _ = rstream.observe(st, torch.from_numpy(X[None, t]),
                                torch.from_numpy(y[None, t]), k=K)
        window.append(t)
    want = rstream.from_fit(X[None, window], y[None, window], k=K,
                            capacity=32, device="cpu")
    _assert_same_window(st, want)


@pytest.mark.parametrize("i", [0, 6, 19])
@pytest.mark.parametrize("kind", ["linear", "ties"])
def test_evict_matches_jax_evict(kind, i):
    """The JAX ``evict`` and the port's on one converted wrapped state."""
    cap, n0, T = 24, 20, 29
    X, y = _data(5, T, kind)
    jst = jstream.from_fit(jnp.asarray(X[:n0]), jnp.asarray(y[:n0]), k=K,
                           capacity=cap)
    for t in range(n0, T):
        jst = jstream.evict_oldest(jst, k=K)
        jst, _ = jstream.observe(jst, jnp.asarray(X[t]), jnp.asarray(y[t]),
                                 k=K)
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jst)]
    assert int(leaves[6]) > 0  # head: the ring wrapped
    st = convert.reg_state_from_numpy([a[None] for a in leaves], "cpu")
    got = convert.reg_state_to_numpy(rstream.evict(st, i, k=K))
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(
        jstream.evict(jst, i, k=K))]
    for j, (g, w) in enumerate(zip(got, want)):
        assert g[0].shape == w.shape and g.dtype == w.dtype, j
        if j in INT_LEAVES:
            np.testing.assert_array_equal(g[0], w, err_msg=f"leaf {j}")
        else:
            np.testing.assert_allclose(g[0], w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"leaf {j}")


# ---------------------------------------------------------------------------
# core.regression: icp_intervals, blocked fit and standard path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,t,k,eps", [(60, 30, 3, 0.1), (19, 10, 7, 0.1),
                                       (40, 13, 1, 0.2), (50, 41, 5, 0.05)])
def test_icp_intervals_match_jax(n, t, k, eps):
    """Within 1e-4, the rank included: n - t = 9 at eps 0.1 puts (1 -
    eps)(n_cal + 1) one ulp above 9 in float64, and JAX's float32 ceil
    takes 9."""
    X, y = _data(n + k, n + 8)
    Xt = X[n:]
    got = reg.icp_intervals(torch.from_numpy(X[:n]), torch.from_numpy(y[:n]),
                            torch.from_numpy(Xt), k=k, t=t, epsilon=eps)
    want = jreg.icp_intervals(jnp.asarray(X[:n]), jnp.asarray(y[:n]),
                              jnp.asarray(Xt), k=k, t=t, epsilon=eps)
    assert got.shape == (8, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_icp_intervals_cover():
    X, y = synthetic.make_regression(2000, 10, seed=1)
    X, y = (torch.from_numpy(a.astype(np.float32)) for a in (X, y))
    iv = reg.icp_intervals(X[:1500], y[:1500], X[1500:], k=7, t=750,
                           epsilon=0.1)
    inside = (iv[:, 0] <= y[1500:]) & (y[1500:] <= iv[:, 1])
    assert float(inside.float().mean()) >= 0.85


@pytest.mark.parametrize("kind", ["linear", "ties"])
def test_blocked_fit_and_standard_equal_unblocked(kind, monkeypatch):
    """Row blocks of 1, 5 or 37 distances rows (forced small) give the
    bits of one block, for ``fit`` (one set and a batch of tenants) and
    for ``ab_standard``'s augmented rows (blocks within and across test
    points)."""
    X, y = _data(11, 30, kind)
    Xt = torch.from_numpy(_data(12, 6, kind)[0])
    X, y = torch.from_numpy(X), torch.from_numpy(y)
    whole = (reg.fit_lists(X, y, k=K), reg.fit_lists(X.view(2, 15, DIM),
                                                     y.view(2, 15), k=K),
             reg.ab_standard(X, y, Xt, k=K))
    for rows in (1, 5, 37):
        monkeypatch.setattr(reg, "BLOCK_ELEMS", rows * 31)
        got = (reg.fit_lists(X, y, k=K), reg.fit_lists(X.view(2, 15, DIM),
                                                       y.view(2, 15), k=K),
               reg.ab_standard(X, y, Xt, k=K))
        for g, w in zip(got, whole):
            assert all(torch.equal(a, b) for a, b in zip(g, w)), rows


def test_ab_standard_matches_jax():
    X, y = _data(13, 40)
    Xt = _data(14, 5)[0]
    got = reg.ab_standard(*map(torch.from_numpy, (X, y, Xt)), k=K)
    for j in range(Xt.shape[0]):
        want = jreg.ab_standard(jnp.asarray(X), jnp.asarray(y),
                                jnp.asarray(Xt[j]), k=K)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[j].numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the registry's knn_regression
# ---------------------------------------------------------------------------


def _batched(st):
    """A registry state (no tenant axis) as a batch of one tenant."""
    return rstream.RegStreamState.from_leaves([t[None] for t in st.leaves()])


def _ill_rows(state, Xq, k):
    Xg, yg, ap, _, kth, kl, live = rstream.arrival_stats(state, k=k)
    d, a = rsess._test_score(yg, live, torch.from_numpy(Xq)[None], Xg, k=k)
    return ill_conditioned(d, kth, live, ap, kl, a, k).sum(-1)[0]


def _assert_state_close(cp, jcp):
    for j, (g, w) in enumerate(zip(convert.reg_state_to_numpy(cp._state),
                                   jax.tree_util.tree_leaves(jcp._state))):
        w = np.asarray(w)
        assert g.shape == w.shape, j
        if j in INT_LEAVES:
            np.testing.assert_array_equal(g, w, err_msg=f"leaf {j}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"leaf {j}")


@pytest.mark.parametrize("k", [1, 3, 7])
def test_registry_knn_regression_matches_jax(k):
    n = 40
    X, y = _data(20 + k, n + 3)
    Xq = _data(30 + k, 12)[0]
    tq = (np.linspace(-4.0, 4.0, 9) + 0.0137).astype(np.float32)
    jcp = jregistry.ConformalPredictor("knn_regression", k=k, t_query=tq)
    cp = registry.ConformalPredictor("knn_regression", device="cpu", k=k,
                                     t_query=tq)
    for p in (jcp, cp):
        p.fit(X[:n], y[:n])
    _assert_state_close(cp, jcp)
    for t in (n, n + 1, n + 2):
        jcp.observe(X[t], float(y[t]))
        cp.observe(X[t], float(y[t]))
    for i in (0, 17, -1):
        jcp.evict(i)
        cp.evict(i)
    assert cp.n == jcp.n == n
    _assert_state_close(cp, jcp)
    got, want = cp.pvalues(Xq).numpy(), np.asarray(jcp.pvalues(Xq))
    assert got.shape == want.shape == (12, 9)
    np.testing.assert_allclose(got, want, atol=1e-5)
    got = cp.intervals(Xq, 0.1).numpy()
    want = np.asarray(jcp.intervals(Xq, 0.1))
    ok = _ill_rows(_batched(cp._state), Xq, k) == 0
    assert got.shape == want.shape == (12, 2) and ok.mean() >= 0.4
    np.testing.assert_array_equal(np.isnan(got[ok]), np.isnan(want[ok]))
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-4)


def test_registry_knn_regression_equals_refit_bitwise():
    """Served state and reads == a fresh predictor fitted on the window."""
    X, y = _data(40, 36, "ties")
    cp = registry.ConformalPredictor("knn_regression", device="cpu", k=K)
    cp.fit(X[:30], y[:30])
    window = list(range(30))
    for t, i in zip(range(30, 36), (0, 29, 11, -1, 5, 3)):
        cp.observe(X[t], y[t])
        window.append(t)
        cp.evict(i)
        del window[i]
    ref = registry.ConformalPredictor("knn_regression", device="cpu", k=K)
    ref.fit(X[window], y[window])
    _assert_same_window(_batched(cp._state), _batched(ref._state))
    Xq = _data(41, 7)[0]
    a, b = cp.intervals(Xq, EPS), ref.intervals(Xq, EPS)
    assert torch.equal(a.isnan(), b.isnan())
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    st = reg.fit(torch.from_numpy(X[window]), torch.from_numpy(y[window]),
                 k=K)
    want = reg.intervals_optimized(st, torch.from_numpy(Xq), k=K,
                                   epsilon=EPS)
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(want))


def test_float_labels_survive_fit():
    """Regression labels reach the state as float32 (the classifiers'
    int32 cast does not apply to them)."""
    X, _ = _data(50, 10)
    y = np.full(10, 0.7, np.float32)
    cp = registry.ConformalPredictor("knn_regression", device="cpu", k=K)
    cp.fit(X, y)
    assert cp._state.y.dtype == torch.float32
    assert torch.equal(cp._state.y, torch.full((10,), 0.7))
    cp.observe(X[0], 0.7)
    assert float(cp._state.y[-1]) == pytest.approx(0.7)
    knn = registry.ConformalPredictor("knn", device="cpu", k=K)
    knn.fit(X, np.arange(10) % 2)
    assert knn._state.y.dtype == torch.int32


def test_regression_errors_match_jax():
    X, y = _data(60, 20)
    for mod, kw in ((jregistry, {}), (registry, {"device": "cpu"})):
        cp = mod.ConformalPredictor("knn_regression", k=K, **kw).fit(X, y)
        with pytest.raises(ValueError, match="t_query"):
            cp.pvalues(X[:2])
        with pytest.raises(IndexError, match="out of range"):
            cp.evict(20)
        with pytest.raises(IndexError, match="out of range"):
            cp.evict(-21)
        clf = mod.ConformalPredictor("knn", k=K, **kw)
        clf.fit(X, (np.arange(20) % 2).astype(np.int32))
        with pytest.raises(NotImplementedError, match="interval"):
            clf.intervals(X[:2], 0.1)
    assert registry.get("knn_regression").defaults == \
        jregistry.get("knn_regression").defaults


def test_serve_refuses_the_regression_measure():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="regression measure; use "
                       "--regression"):
        serve.main(["--measure", "knn_regression", "--sessions", "2",
                    "--device", "cpu"])


# ---------------------------------------------------------------------------
# the port's copies of the paper config and make_regression
# ---------------------------------------------------------------------------


def test_paper_config_equals_jax():
    from dataclasses import asdict

    assert asdict(CONFIG) == asdict(JCONFIG)
    assert asdict(PaperConfig()) == asdict(JPaperConfig())
    assert np.array_equal(CONFIG.paper_n_grid(), JCONFIG.paper_n_grid())
    assert CONFIG.paper_n_grid().dtype == JCONFIG.paper_n_grid().dtype
    assert CONFIG.tree_depth == 10


@pytest.mark.parametrize("seed,n,p,inf", [(0, 50, 30, 10), (3, 7, 4, 10),
                                          (11, 100, 784, 64)])
def test_make_regression_equals_jax(seed, n, p, inf):
    got = synthetic.make_regression(n, p, n_informative=inf, noise=0.5,
                                    seed=seed)
    want = jsyn.make_regression(n, p, n_informative=inf, noise=0.5,
                                seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.cuda
def test_pvalue_at_on_the_card_equals_the_cpu_bitwise():
    """``core.regression.pvalue_at`` divides by a device scalar, so the
    card rounds ``(count + 1) / (n + 1)`` as the CPU does: CUDA turns a
    Python-float divisor into a multiply by its reciprocal, and every
    count of 1..n + 1 is met here at three n."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for n in (40, 99, 4109):
        a_vec = torch.arange(1, n + 1, dtype=torch.float32)[None]
        b_vec, a = torch.zeros_like(a_vec), torch.zeros(1)
        t = torch.arange(n + 1, dtype=torch.float32) + 0.5  # counts n..0
        want = reg.pvalue_at(a_vec, b_vec, a, t)
        got = reg.pvalue_at(a_vec.cuda(), b_vec.cuda(), a.cuda(), t.cuda())
        assert torch.equal(got.cpu(), want)
        assert torch.equal(want[0], (torch.arange(n, -1, -1) + 1.0)
                           / torch.tensor(n + 1.0))
