"""The port's bootstrap measure (paper Section 6, Algorithm 3) against the
JAX package, and its exactness re-proved inside the port.

The forest: the port's batched ``boot_forest`` (one pass a tree level) ==
the per-tree numpy oracle ``repro.kernels.ref.boot_fit_tree`` /
``boot_predict_tree`` bit for bit, structure, thresholds and predictions,
on an integer grid and on continuous data (the port rounds ``lo + u * (hi
- lo)`` as three f32 operations, as numpy does); against JAX's vmapped
route features, leaves and predictions exact, thresholds within 1e-5 (XLA
may contract that expression into an FMA: the JAX package's own
tolerance).

The measure: the JAX side runs with ``REPRO_BOOT_FOREST=ref`` (its numpy
oracle: no XLA compile), the port on the CPU. The draws are host numpy
keyed by ``(seed, tag, id)`` in both, so the pool itself is compared:
``draw_ids``, ``W``, ``star``, ``E``, ``E_i``, the trees, ``pre_votes``
and the p-values with ``np.array_equal``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.measures import bootstrap as jboot  # noqa: E402
from repro.core.predictor import ConformalClassifier as JaxClassifier  # noqa: E402,E501
from repro.data.synthetic import make_classification  # noqa: E402
from repro.kernels import boot_forest as jforest  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.serving import ConformalPredictor as JaxPredictor  # noqa: E402
from repro_torch.core.measures import bootstrap as boot  # noqa: E402
from repro_torch.core.predictor import ConformalClassifier  # noqa: E402
from repro_torch.kernels import boot_forest, ops, ref  # noqa: E402
from repro_torch.serving import registry  # noqa: E402

B, DEPTH = 4, 3
STATE_ARRAYS = ("X", "y", "uids", "W", "star", "elig", "counts", "feat",
                "thresh", "leaf", "pre_pred", "pre_votes")


def _data(n, seed, n_features=6, **kw):
    X, y = make_classification(n_samples=n, n_features=n_features,
                               seed=seed, **kw)
    return X.astype(np.float32), y.astype(np.int32)


def _assert_states_equal(a, b):
    for f in STATE_ARRAYS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.draw_ids == b.draw_ids
    assert a.E == b.E
    assert a.E_i == b.E_i
    assert (a.next_uid, a.next_draw) == (b.next_uid, b.next_draw)


def _forest_inputs(seed, m, p, S, depth, nl, grid):
    rng = np.random.default_rng(seed)
    nn = boot_forest.n_nodes(depth)
    if grid:  # integer features, dyadic uniforms: every product exact
        X = rng.integers(0, 5, (m, p)).astype(np.float32)
        u = (rng.integers(0, 256, (S, nn)) / 256.0).astype(np.float32)
    else:
        X = rng.standard_normal((m, p)).astype(np.float32)
        u = rng.random((S, nn), dtype=np.float32)
    y = rng.integers(0, nl, m).astype(np.int32)
    W = rng.integers(0, 3, (S, m)).astype(np.int32)
    fc = rng.integers(0, p, (S, nn)).astype(np.int32)
    Xq = (rng.integers(0, 5, (9, p)) if grid
          else rng.standard_normal((9, p))).astype(np.float32)
    return X, y, W, fc, u, Xq


def _port_forest(X, y, W, fc, u, Xq, nl, depth):
    feat, thresh, leaf = ops.boot_fit_forest(X, y, W, fc, u, n_labels=nl,
                                             depth=depth, device="cpu")
    preds = ops.boot_forest_predict(feat, thresh, leaf, Xq, device="cpu")
    return feat, thresh, leaf, preds


# ---------------------------------------------------------------------------
# the forest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid,seed,m,p,S,depth,nl", [
    (True, 0, 26, 4, 12, 3, 3), (True, 1, 40, 3, 8, 4, 2),
    (False, 3, 40, 7, 30, 4, 2), (False, 4, 17, 5, 9, 2, 4)])
def test_forest_equals_numpy_oracle_bitwise(grid, seed, m, p, S, depth, nl):
    X, y, W, fc, u, Xq = _forest_inputs(seed, m, p, S, depth, nl, grid)
    feat, thresh, leaf, preds = _port_forest(X, y, W, fc, u, Xq, nl, depth)
    assert feat.dtype == leaf.dtype == np.int32
    assert thresh.dtype == np.float32
    splits = 0
    for s in range(S):
        f2, t2, l2 = jref.boot_fit_tree(X, y, W[s], fc[s], u[s], nl, depth)
        np.testing.assert_array_equal(feat[s], f2)
        np.testing.assert_array_equal(thresh[s].view(np.int32),
                                      t2.view(np.int32))
        np.testing.assert_array_equal(leaf[s], l2)
        np.testing.assert_array_equal(
            preds[s], jref.boot_predict_tree(f2, t2, l2, Xq))
        # the port's own per-tree plain version, the same bits
        tt = [torch.from_numpy(a) for a in (X, y, W[s], fc[s], u[s])]
        f3, t3, l3 = ref.boot_fit_tree(*tt, nl, depth)
        assert np.array_equal(f3.numpy(), f2) and np.array_equal(
            t3.numpy().view(np.int32), t2.view(np.int32)) and \
            np.array_equal(l3.numpy(), l2)
        p3 = ref.boot_predict_tree(f3, t3, l3, torch.from_numpy(Xq))
        assert np.array_equal(p3.numpy(), preds[s])
        splits += int((f2 >= 0).sum())
    assert splits > S  # the trees really split


def test_forest_matches_jax_vmapped_route():
    """Against the JAX package's jitted forest: features, leaves and
    predictions exact; thresholds within 1e-5 (its own test's tolerance:
    XLA may fuse the threshold's multiply-add)."""
    X, y, W, fc, u, Xq = _forest_inputs(3, 40, 7, 30, 4, 2, grid=False)
    feat, thresh, leaf, preds = _port_forest(X, y, W, fc, u, Xq, 2, 4)
    jf, jt, jl = (np.asarray(a) for a in jforest.fit_forest(
        X, y, W, fc, u, n_labels=2, depth=4))
    np.testing.assert_array_equal(feat, jf)
    np.testing.assert_array_equal(leaf, jl)
    np.testing.assert_allclose(thresh, jt, atol=1e-5)
    jp = np.asarray(jforest.forest_predict(jf, jt, jl, Xq))
    np.testing.assert_array_equal(preds, jp)


def test_first_argmax_ties_and_tied_leaves():
    c = torch.tensor([[2, 2], [0, 3], [0, 0], [1, 4]], dtype=torch.int32)
    assert ref.first_argmax(c).tolist() == [0, 1, 0, 1]
    c3 = torch.tensor([[0, 3, 3], [5, 1, 5], [2, 2, 2]])
    assert ref.first_argmax(c3).tolist() == [1, 0, 0]
    # a forest whose nodes tie on purpose: two labels with equal weights
    X = np.arange(8, dtype=np.float32)[:, None].repeat(2, 1)
    y = np.array([0, 1, 1, 0, 2, 1, 2, 0], np.int32)
    W = np.array([[1] * 8, [0, 1, 1, 0, 0, 0, 2, 2], [1, 0, 0, 1] * 2,
                  [0] * 8], np.int32)  # the last tree is empty
    nn = boot_forest.n_nodes(2)
    fc = np.zeros((4, nn), np.int32)
    u = np.full((4, nn), 0.5, np.float32)
    feat, thresh, leaf, _ = _port_forest(X, y, W, fc, u, X, 3, 2)
    for s in range(4):
        f2, t2, l2 = jref.boot_fit_tree(X, y, W[s], fc[s], u[s], 3, 2)
        np.testing.assert_array_equal(feat[s], f2)
        np.testing.assert_array_equal(thresh[s], t2)
        np.testing.assert_array_equal(leaf[s], l2)
    assert leaf[0, 0] == 0  # counts [3, 3, 2]: the first of the tie
    assert (feat[3] == -1).all() and (thresh[3] == 0).all() \
        and (leaf[3] == 0).all()  # an empty tree: no split, leaf 0


def test_forest_is_batch_independent():
    """A sub-batch of trees (and of query rows) equals the slice of the
    full batch: no tree reads another's rows."""
    X, y, W, fc, u, Xq = _forest_inputs(5, 19, 5, 7, 3, 2, grid=False)
    full = _port_forest(X, y, W, fc, u, Xq, 2, 3)
    sub = _port_forest(X, y, W[2:5], fc[2:5], u[2:5], Xq[3:7], 2, 3)
    for a, b in zip(full[:3], sub[:3]):
        np.testing.assert_array_equal(a[2:5], b)
    np.testing.assert_array_equal(full[3][2:5, 3:7], sub[3])


# ---------------------------------------------------------------------------
# the measure against the JAX package (its numpy-oracle route)
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_oracle(monkeypatch):
    monkeypatch.setenv("REPRO_BOOT_FOREST", "ref")


def test_fit_and_pvalues_equal_jax(jax_oracle):
    X, y = _data(30, 0)
    kw = dict(n_labels=2, B=B, depth=DEPTH, seed=3)
    js = jboot.fit(X[:24], y[:24], **kw)
    ts = boot.fit(X[:24], y[:24], **kw, device="cpu")
    _assert_states_equal(ts, js)
    assert ts.b_prime == js.b_prime
    pt = boot.pvalues_optimized(ts, X[24:])
    pj = jboot.pvalues_optimized(js, X[24:])
    assert pt.dtype == pj.dtype == np.float64
    assert np.array_equal(pt, pj)
    st = boot.pvalues_standard(X[:24], y[:24], X[24:27], **kw,
                               device="cpu")
    sj = jboot.pvalues_standard(X[:24], y[:24], X[24:27], **kw)
    assert np.array_equal(st, sj)


def test_streaming_updates_equal_jax(jax_oracle):
    X, y = _data(40, 1)
    kw = dict(n_labels=2, B=B, depth=DEPTH, seed=1)
    js = jboot.fit(X[:16], y[:16], **kw)
    ts = boot.fit(X[:16], y[:16], **kw, device="cpu")
    for t, op in enumerate("aeaaeea"):
        if op == "a":
            js = jboot.incremental_add(js, X[16 + t], int(y[16 + t]))
            ts = boot.incremental_add(ts, X[16 + t], int(y[16 + t]))
        else:
            js = jboot.decremental_remove(js, 3 * t % js.n)
            ts = boot.decremental_remove(ts, 3 * t % ts.n)
        _assert_states_equal(ts, js)
    assert np.array_equal(boot.pvalues_optimized(ts, X[35:39]),
                          jboot.pvalues_optimized(js, X[35:39]))


@pytest.mark.parametrize("seed,n_ops,evict_bias",
                         [(0, 6, 0.5), (1, 1, 0.2), (2, 10, 0.6),
                          (3, 8, 0.35)])
def test_observe_evict_interleaving_equals_rebuild(seed, n_ops, evict_bias):
    """Any interleaving of observe / evict == ``fit_from_samples`` on the
    same effective sample set, inside the port, bit for bit."""
    X, y = _data(40, seed)
    state = boot.fit(X[:16], y[:16], n_labels=2, B=B, depth=DEPTH,
                     seed=seed % 5, device="cpu")
    rng = np.random.default_rng(seed + 1)
    t = 16
    for _ in range(n_ops):
        if state.n > 6 and rng.random() < evict_bias:
            state = boot.decremental_remove(state,
                                            int(rng.integers(0, state.n)))
        else:
            state = boot.incremental_add(state, X[t % 40], int(y[t % 40]))
            t += 1
    rebuilt = boot.rebuild(state)
    _assert_states_equal(state, rebuilt)
    pa = boot.pvalues_optimized(state, X[35:39])
    pb = boot.pvalues_optimized(rebuilt, X[35:39])
    assert pa.tobytes() == pb.tobytes()


def test_starvation_and_label_errors():
    X, y = _data(20, 2)
    with pytest.raises(ValueError, match="starved") as e:
        boot.fit(X, y, n_labels=2, B=5, depth=DEPTH, seed=0, max_bprime=3,
                 device="cpu")
    assert "B=5" in str(e.value)
    with pytest.raises(ValueError, match="labels"):
        boot.fit(X, y + 5, n_labels=2, B=B, depth=DEPTH, seed=0,
                 device="cpu")
    state = boot.fit(X, y, n_labels=2, B=3, depth=2, seed=0, device="cpu")
    with pytest.raises(ValueError, match="labels"):
        boot.incremental_add(state, X[0], 2)
    with pytest.raises(IndexError, match="out of range"):
        boot.decremental_remove(state, 20)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimized", [True, False])
def test_classifier_equals_jax(jax_oracle, optimized):
    X, y = _data(30, 4)
    kw = dict(measure="bootstrap", n_labels=2, B=3, tree_depth=2,
              optimized=optimized, seed=2)
    tp = ConformalClassifier(**kw, device="cpu").fit(X[:24], y[:24])
    jp = JaxClassifier(**kw).fit(X[:24], y[:24])
    got = tp.predict_pvalues(X[24:28])
    want = np.asarray(jp.predict_pvalues(X[24:28]))
    assert got.dtype == torch.float32 and got.shape == (4, 2)
    assert np.array_equal(got.numpy(), want.astype(np.float32))
    sets = tp.predict_set(X[24:28], eps=0.2)
    assert sets.dtype == torch.bool and sets.shape == (4, 2)


def test_registry_spec_equals_jax(jax_oracle):
    X, y = _data(40, 13)
    hp = dict(B=B, depth=DEPTH, n_labels=2, seed=5)
    tcp = registry.ConformalPredictor("bootstrap", device="cpu", **hp)
    jcp = JaxPredictor("bootstrap", **hp)
    tcp.fit(X[:20], y[:20])
    jcp.fit(X[:20], y[:20])
    for t in range(20, 26):
        tcp.observe(X[t], int(y[t]))
        jcp.observe(X[t], int(y[t]))
        if tcp.n > 20:
            tcp.evict(0)
            jcp.evict(0)
    assert tcp.n == jcp.n == 20
    assert isinstance(tcp._ctx, boot.DrawStream)
    _assert_states_equal(tcp._state, jcp._state)
    _assert_states_equal(tcp._state, boot.rebuild(tcp._state))
    got = tcp.pvalues(X[30:34])
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(),
                          np.asarray(jcp.pvalues(X[30:34])))
    assert "bootstrap" in registry.available()
    assert registry.get("bootstrap").defaults == {
        "n_labels": 2, "B": 10, "depth": 5, "seed": 0, "max_bprime": 100000}
    with pytest.raises(TypeError, match="unknown hyperparameters"):
        registry.ConformalPredictor("bootstrap", device="cpu", k=7)


def test_forest_calls_count_only_on_the_card():
    X, y, W, fc, u, Xq = _forest_inputs(6, 12, 3, 4, 2, 2, grid=True)
    ops.reset_launch_counts()
    _port_forest(X, y, W, fc, u, Xq, 2, 2)
    c = ops.launch_counts()
    assert c["boot_fit_forest"] == c["boot_forest_predict"] == 0
    assert ops.forest_calls() == {"boot_fit_forest": 0,
                                  "boot_forest_predict": 0, "h2d_bytes": 0}
    # forest calls are not kernel launches: kept apart from them
    assert not set(ops.FOREST) & set(ops.kernel_launches())


@pytest.mark.cuda
def test_card_equals_cpu_bitwise():
    """The forest and the p-values on the card == on the CPU, bit for
    bit (the smoke repeats this at n = 2,154)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    X, y = _data(60, 7)
    kw = dict(n_labels=2, B=B, depth=4, seed=1)
    sc = boot.fit(X[:50], y[:50], **kw, device="cpu")
    sg = boot.fit(X[:50], y[:50], **kw, device="cuda")
    _assert_states_equal(sg, sc)
    assert np.array_equal(boot.pvalues_optimized(sg, X[50:]),
                          boot.pvalues_optimized(sc, X[50:]))
    for grid in (True, False):
        Xf, yf, W, fc, u, Xq = _forest_inputs(8, 300, 9, 64, 5, 3, grid)
        ops.reset_launch_counts()
        out = ops.boot_fit_forest(Xf, yf, W, fc, u, n_labels=3, depth=5,
                                  device="cuda")
        calls = ops.forest_calls()
        assert calls["boot_fit_forest"] == 1 and calls["h2d_bytes"] > 0
        want = ops.boot_fit_forest(Xf, yf, W, fc, u, n_labels=3, depth=5,
                                   device="cpu")
        for a, b in zip(out, want):
            assert np.array_equal(a.view(np.int32), b.view(np.int32))
        assert np.array_equal(
            ops.boot_forest_predict(*out, Xq, device="cuda"),
            ops.boot_forest_predict(*want, Xq, device="cpu"))
