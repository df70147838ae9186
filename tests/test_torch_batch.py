"""The port's batch full-CP classifiers against the JAX package, and the
port's own exactness properties.

The same seeded numpy inputs go through ``repro.core`` / ``repro.serving``
and through ``repro_torch``. Scores match ``allclose`` at the JAX tests'
tolerances (1e-5 relative for k-NN and KDE, 1e-4 for LS-SVM). p-values
are compared as counts, exactly, except candidates whose score lies within
that tolerance of some training score (near-ties, where the two
frameworks' rounding may order them differently); fewer than 10 % may be
flagged. Inside the port the exactness properties hold bit for bit: KDE
optimized == standard, incremental == refit for KDE and k-NN, k-NN
decremental == refit, and a row's bits do not depend on the batch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import icp as jicp  # noqa: E402
from repro.core import predictor as jpred  # noqa: E402
from repro.core import pvalues as jpv  # noqa: E402
from repro.core.measures import kde as jkde  # noqa: E402
from repro.core.measures import knn as jknn  # noqa: E402
from repro.core.measures import lssvm as jlssvm  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.serving import registry as jreg  # noqa: E402
from repro_torch.core import icp, predictor  # noqa: E402
from repro_torch.core import pvalues as pv  # noqa: E402
from repro_torch.core.measures import kde, knn, lssvm  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.serving import convert, registry  # noqa: E402

N, P, M, LBL, K, H = 60, 5, 6, 3, 4, 1.3
TOL = {"knn": 1e-5, "simplified_knn": 1e-5, "kde": 1e-5, "lssvm": 1e-4}


def _data(n, seed, labels=LBL, p=P):
    X, y = synthetic.make_classification(n, p, n_classes=labels, seed=seed)
    return X.astype(np.float32), y


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _counts(p, n):
    return np.rint(np.asarray(p, np.float64) * (n + 1)).astype(np.int64)


def _ties(alphas, alpha, tol):
    """``(...,)`` True where some training score is within ``tol`` of the
    candidate's (relative, with a small absolute floor)."""
    alphas, alpha = np.asarray(alphas), np.asarray(alpha)[..., None]
    tol = np.asarray(tol)
    near = np.abs(alphas - alpha) <= tol * np.maximum(
        np.abs(alphas), np.abs(alpha)) + 1e-7
    return near.any(-1)


def _assert_counts(got, want, n, ties):
    got, want = _counts(got, n), _counts(want, n)
    assert ties.mean() < 0.1, f"{ties.sum()} of {ties.size} flagged"
    np.testing.assert_array_equal(got[~ties], want[~ties])


def _lssvm_tol(st, phi_t):
    """Per-training-point absolute allowance of an LS-SVM LOO score beyond
    the JAX tests' 1e-4: the float32 cancellation in ``s - t`` (``s``, ``t``
    ~ |phi|^2, large for ``poly2`` features), which enters the score's
    numerator and its denominator ``rho + s - t``: 16 roundings of their
    size over the denominator, times ``1 + |score|``."""
    sp = lssvm.incremental_add(st, phi_t, 1.0)
    s = ((sp.Phi @ sp.C) * sp.Phi).sum(-1)[:-1]
    t = (sp.Phi * sp.Phi).sum(1)[:-1]
    return (16 * 2.0**-24 * (s.abs() + t.abs() + sp.rho)
            / (sp.rho + s - t).abs()).numpy()


def _port_scores(fn, m, labels):
    """``(alphas (m, L, n), alpha (m, L))`` from a per-candidate scorer."""
    out = [[fn(t, lbl) for lbl in labels] for t in range(m)]
    return (np.stack([[a.numpy() for a, _ in row] for row in out]),
            np.array([[float(b) for _, b in row] for row in out]))


# ---------------------------------------------------------------------------
# the rest of the surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_matches_the_jax_copy(seed):
    for a, b in zip(synthetic.make_classification(80, 9, n_classes=3,
                                                  seed=seed),
                    jsyn.make_classification(80, 9, n_classes=3, seed=seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    X, y = jsyn.make_classification(50, 4, seed=seed)
    for a, b in zip(synthetic.train_test_split(X, y, 0.3, seed),
                    jsyn.train_test_split(X, y, 0.3, seed)):
        np.testing.assert_array_equal(a, b)


def test_pvalue_helpers_match_jax():
    rng = np.random.default_rng(3)
    alphas = np.round(rng.random((4, 3, 30)) * 5).astype(np.float32)
    alpha = np.round(rng.random((4, 3)) * 5).astype(np.float32)
    tau = rng.random((4, 3)).astype(np.float32)
    ja, jb, jt = map(jnp.asarray, (alphas, alpha, tau))
    ta, tb, tt = map(_t, (alphas, alpha, tau))
    np.testing.assert_array_equal(pv.pvalue(ta, tb).numpy(),
                                  np.asarray(jpv.pvalue(ja, jb)))
    np.testing.assert_array_equal(pv.count_ge(ta, tb).numpy(),
                                  np.asarray(jpv.count_ge(ja, jb)))
    np.testing.assert_allclose(pv.smoothed_pvalue(ta, tb, tt).numpy(),
                               np.asarray(jpv.smoothed_pvalue(ja, jb, jt)),
                               rtol=1e-6)
    p = pv.pvalue(ta, tb)[0]
    np.testing.assert_allclose(pv.fuzziness(p).numpy(),
                               np.asarray(jpv.fuzziness(jnp.asarray(p))),
                               rtol=1e-6)
    y = np.array([0, 2, 1, 1], np.int32)
    pvals = pv.pvalue(ta, tb)
    for a, b in zip(pv.coverage(pvals, _t(y), 0.3),
                    jpv.coverage(jnp.asarray(pvals.numpy()), jnp.asarray(y),
                                 0.3)):
        assert float(a) == pytest.approx(float(b))


def test_bootstrap_is_not_ported_yet():
    """Bootstrap, once the one measure missing here, is ported: the
    classifier and the registry build it, and the registry lists every
    measure the JAX registry lists (bootstrap's parity is in
    ``tests/test_torch_bootstrap.py``, knn_regression's in
    ``tests/test_torch_regression_registry.py``)."""
    clf = predictor.ConformalClassifier("bootstrap", device="cpu")
    assert (clf.B, clf.tree_depth) == (10, 5)
    assert registry.ConformalPredictor("bootstrap", device="cpu").hp == {
        "n_labels": 2, "B": 10, "depth": 5, "seed": 0, "max_bprime": 100000}
    assert registry.available() == jreg.available() == (
        "bootstrap", "kde", "knn", "knn_regression", "lssvm",
        "simplified_knn")


@pytest.mark.parametrize("make", [
    lambda: predictor.ConformalClassifier("kde"),
    lambda: predictor.InductiveConformalClassifier("knn"),
    lambda: registry.ConformalPredictor("kde"),
], ids=["ConformalClassifier", "InductiveConformalClassifier",
        "ConformalPredictor"])
def test_default_device_is_cuda(make):
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_lssvm_label_checks_raise_as_in_jax():
    X, y = _data(20, 4, labels=2)
    for mod, kw in ((jreg, {}), (registry, {"device": "cpu"})):
        with pytest.raises(ValueError, match="binary"):
            mod.ConformalPredictor("lssvm", n_labels=3, **kw).fit(X, y)
        with pytest.raises(ValueError, match="labels in"):
            mod.ConformalPredictor("lssvm", **kw).fit(X, 2 * y)
        cp = mod.ConformalPredictor("lssvm", **kw).fit(X, y)
        with pytest.raises(ValueError, match="labels in"):
            cp.observe(X[0], 2)
    with pytest.raises(ValueError, match="binary"):
        jpred.ConformalClassifier("lssvm", n_labels=3)
    with pytest.raises(ValueError, match="binary"):
        predictor.ConformalClassifier("lssvm", n_labels=3, device="cpu")


@pytest.mark.parametrize("cls,make", [
    ("KnnState", lambda X, y: jknn.fit(X, y, k=K)),
    ("KdeState", lambda X, y: jkde.fit(X, y, h=H, n_labels=LBL)),
    ("LssvmState", lambda X, y: jlssvm.fit(X, 2.0 * (y % 2) - 1.0, 1.0)),
    ("IcpKnnState", lambda X, y: jicp.fit_knn(X, y, k=K, simplified=False,
                                              t=30)),
    ("IcpKdeState", lambda X, y: jicp.fit_kde(X, y, h=H, p_dim=P,
                                              n_labels=LBL, t=30)),
    ("IcpLssvmState", lambda X, y: jicp.fit_lssvm(
        X, 2.0 * (y % 2) - 1.0, 1.0, t=30)),
])
def test_batch_states_convert_both_ways(cls, make):
    X, y = _data(N, 11)
    jstate = make(jnp.asarray(X), jnp.asarray(y))
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)]
    klass = {"KnnState": knn.KnnState, "KdeState": kde.KdeState,
             "LssvmState": lssvm.LssvmState, "IcpKnnState": icp.IcpKnnState,
             "IcpKdeState": icp.IcpKdeState,
             "IcpLssvmState": icp.IcpLssvmState}[cls]
    state = convert.batch_state_from_numpy(klass, leaves, device="cpu")
    back = convert.batch_state_to_numpy(state)
    for a, b in zip(back, leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_a_single_row_from_numpy_passes_the_pairwise_layout_check():
    """``torch.as_tensor`` of a one-row numpy view reports a 0 row stride;
    the kernel never reads it, so the layout check must not refuse it (it
    did, and the registry launcher's per-point reads failed on the card)."""
    from repro_torch.kernels.pairwise_dist import rows_contiguous

    xs = np.zeros((6, 3, 4), np.float32).swapaxes(0, 1)
    one = torch.as_tensor(np.asarray(xs[1, 2][None])).contiguous()[None]
    assert one.stride(1) != one.shape[2] and rows_contiguous(one)
    assert rows_contiguous(torch.zeros((2, 5, 4)))
    assert not rows_contiguous(torch.zeros((2, 4, 5)).mT)


@pytest.mark.parametrize("measure", ["knn", "simplified_knn", "kde",
                                     "lssvm"])
def test_registry_launcher_runs(measure, capsys):
    from repro_torch.launch import serve

    assert serve.main(["--measure", measure, "--sessions", "2", "--steps",
                       "30", "--window", "12", "--dim", "3",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"registry {measure}" in out and "drift flags" in out


# ---------------------------------------------------------------------------
# each measure against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["optimized", "standard"])
@pytest.mark.parametrize("simplified", [False, True])
def test_knn_matches_jax(simplified, path):
    X, y = _data(N, 1)
    Xt, _ = _data(M, 2)
    kw = dict(k=K, simplified=simplified)
    jst = jknn.fit(jnp.asarray(X), jnp.asarray(y), k=K)
    st = knn.fit(_t(X), _t(y), k=K)
    for name in ("best_same", "best_diff"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   rtol=1e-5)
    alphas, alpha = _port_scores(
        lambda t, lbl: knn.scores_optimized(st, _t(Xt[t]), lbl, **kw), M,
        range(LBL))
    ja, jb = _port_scores(lambda t, lbl: tuple(map(
        lambda a: torch.from_numpy(np.asarray(a)), jknn.scores_optimized(
            jst, jnp.asarray(Xt[t]), jnp.int32(lbl), **kw))), M, range(LBL))
    np.testing.assert_allclose(alphas, ja, rtol=1e-5)
    np.testing.assert_allclose(alpha, jb, rtol=1e-5)
    if path == "optimized":
        got = knn.pvalues_optimized(st, _t(Xt), n_labels=LBL, **kw)
        want = jknn.pvalues_optimized(jst, jnp.asarray(Xt), n_labels=LBL,
                                      **kw)
    else:
        got = knn.pvalues_standard(_t(X), _t(y), _t(Xt), n_labels=LBL, **kw)
        want = jknn.pvalues_standard(jnp.asarray(X), jnp.asarray(y),
                                     jnp.asarray(Xt), n_labels=LBL, **kw)
    _assert_counts(got.numpy(), want, N, _ties(alphas, alpha, 1e-5))


@pytest.mark.parametrize("path", ["optimized", "standard"])
def test_kde_matches_jax(path):
    X, y = _data(N, 3)
    Xt, _ = _data(M, 4)
    jst = jkde.fit(jnp.asarray(X), jnp.asarray(y), h=H, n_labels=LBL)
    st = kde.fit(_t(X), _t(y), h=H, n_labels=LBL)
    np.testing.assert_allclose(st.prelim.numpy(), np.asarray(jst.prelim),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(st.class_counts.numpy(),
                                  np.asarray(jst.class_counts))
    kw = dict(h=H, p_dim=P)
    alphas, alpha = _port_scores(
        lambda t, lbl: kde.scores_optimized(st, _t(Xt[t]), lbl, **kw), M,
        range(LBL))
    ja, jb = _port_scores(lambda t, lbl: tuple(map(
        lambda a: torch.from_numpy(np.asarray(a)), jkde.scores_optimized(
            jst, jnp.asarray(Xt[t]), jnp.int32(lbl), **kw))), M, range(LBL))
    np.testing.assert_allclose(alphas, ja, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(alpha, jb, rtol=1e-5, atol=1e-8)
    if path == "optimized":
        got = kde.pvalues_optimized(st, _t(Xt), n_labels=LBL, **kw)
        want = jkde.pvalues_optimized(jst, jnp.asarray(Xt), n_labels=LBL,
                                      **kw)
    else:
        got = kde.pvalues_standard(_t(X), _t(y), _t(Xt), n_labels=LBL, **kw)
        want = jkde.pvalues_standard(jnp.asarray(X), jnp.asarray(y),
                                     jnp.asarray(Xt), n_labels=LBL, **kw)
    _assert_counts(got.numpy(), want, N, _ties(alphas, alpha, 1e-5))


def _jax_rff(p, q, seed):
    """The JAX ``rff`` map's ``W, b`` (``repro/core/measures/lssvm.py``)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.normal(k1, (p, q))),
            np.asarray(jax.random.uniform(k2, (q,), maxval=2 * jnp.pi)))


def _phis(kind, X, Xt, q=16, seed=0):
    jphi, _ = jlssvm.feature_map(kind, X.shape[1], q, seed)
    params = (convert.rff_params_from_numpy(*_jax_rff(X.shape[1], q, seed),
                                            device="cpu")
              if kind == "rff" else None)
    phi, _ = lssvm.feature_map(kind, X.shape[1], q, seed, params=params)
    return ((np.asarray(jphi(jnp.asarray(X))), np.asarray(jphi(
        jnp.asarray(Xt)))), (phi(_t(X)), phi(_t(Xt))))


@pytest.mark.parametrize("kind,path", [("linear", "optimized"),
                                       ("poly2", "optimized"),
                                       ("rff", "optimized"),
                                       ("linear", "standard")])
def test_lssvm_matches_jax(kind, path):
    X, y = _data(40, 5, labels=2, p=4)
    Xt, _ = _data(M, 6, labels=2, p=4)
    Y = (2.0 * y - 1.0).astype(np.float32)
    (jP, jPt), (tP, tPt) = _phis(kind, X, Xt)
    np.testing.assert_allclose(tP.numpy(), jP, rtol=1e-5, atol=1e-6)
    jst = jlssvm.fit(jnp.asarray(jP), jnp.asarray(Y), 1.0)
    st = lssvm.fit(tP, _t(Y), 1.0)
    np.testing.assert_allclose(st.w.numpy(), np.asarray(jst.w), rtol=1e-4,
                               atol=1e-5)
    labels = (-1.0, 1.0)
    alphas, alpha = _port_scores(
        lambda t, c: lssvm.scores_optimized(st, tPt[t], c), M, labels)
    ja, jb = _port_scores(lambda t, c: tuple(map(
        lambda a: torch.from_numpy(np.asarray(a)), jlssvm.scores_optimized(
            jst, jnp.asarray(jPt[t]), jnp.float32(c)))), M, labels)
    cancel = np.stack([_lssvm_tol(st, tPt[t]) for t in range(M)])[:, None]
    gap = np.abs(alphas - ja)
    assert gap.max() > 0  # the frameworks round apart
    assert (gap <= 1e-4 * np.abs(ja) + 1e-4 + cancel * (1 + np.abs(ja))
            ).all()
    np.testing.assert_allclose(alpha, jb, rtol=1e-4, atol=1e-4)
    if path == "optimized":
        got = lssvm.pvalues_optimized(st, tPt)
        want = jlssvm.pvalues_optimized(jst, jnp.asarray(jPt))
    else:
        got = lssvm.pvalues_standard(tP, _t(Y), tPt, rho=1.0)
        want = jlssvm.pvalues_standard(jnp.asarray(jP), jnp.asarray(Y),
                                       jnp.asarray(jPt), rho=1.0)
    _assert_counts(got.numpy(), want, 40,
                   _ties(alphas, alpha, 1e-4 + cancel * (1 + np.abs(ja))
                         / np.maximum(np.abs(ja), 1e-3)))


# ---------------------------------------------------------------------------
# the entry points against JAX
# ---------------------------------------------------------------------------


def _score_fn(measure, clf, Xt):
    st = clf._state
    if measure == "kde":
        return lambda t, lbl: kde.scores_optimized(st, _t(Xt[t]), lbl, h=H,
                                                   p_dim=P)
    if measure == "lssvm":
        return lambda t, lbl: lssvm.scores_optimized(
            st, clf._phi(_t(Xt[t:t + 1]))[0], 2.0 * lbl - 1.0)
    return lambda t, lbl: knn.scores_optimized(
        st, _t(Xt[t]), lbl, k=K, simplified=measure == "simplified_knn")


@pytest.mark.parametrize("optimized", [True, False])
@pytest.mark.parametrize("measure", ["knn", "simplified_knn", "kde",
                                     "lssvm"])
def test_conformal_classifier_matches_jax(measure, optimized):
    labels = 2 if measure == "lssvm" else LBL
    X, y = _data(40, 8, labels=labels)
    Xt, yt = _data(M, 9, labels=labels)
    kw = dict(measure=measure, n_labels=labels, k=K, h=H, rho=1.0)
    jclf = jpred.ConformalClassifier(optimized=optimized, **kw).fit(X, y)
    clf = predictor.ConformalClassifier(optimized=optimized, device="cpu",
                                        **kw).fit(X, y)
    got, want = clf.predict_pvalues(Xt), jclf.predict_pvalues(Xt)
    opt = (clf if optimized else predictor.ConformalClassifier(
        device="cpu", **kw).fit(X, y))
    alphas, alpha = _port_scores(_score_fn(measure, opt, Xt), M,
                                 range(labels))
    ties = _ties(alphas, alpha, TOL[measure])
    _assert_counts(got.numpy(), want, 40, ties)
    sets = clf.predict_set(Xt, 0.2).numpy()
    np.testing.assert_array_equal(sets[~ties], np.asarray(
        jclf.predict_set(Xt, 0.2))[~ties])
    assert got.dtype == torch.float32 and got.shape == (M, labels)


@pytest.mark.parametrize("measure", ["knn", "simplified_knn", "kde",
                                     "lssvm"])
def test_icp_matches_jax(measure):
    labels = 2 if measure == "lssvm" else LBL
    X, y = _data(N, 12, labels=labels)
    Xt, _ = _data(M, 13, labels=labels)
    kw = dict(measure=measure, n_labels=labels, k=K, h=H, train_frac=0.5)
    jclf = jpred.InductiveConformalClassifier(**kw).fit(X, y)
    clf = predictor.InductiveConformalClassifier(device="cpu", **kw).fit(X, y)
    cal = clf._state.calib_scores.numpy()
    np.testing.assert_allclose(cal, np.asarray(jclf._state.calib_scores),
                               rtol=TOL[measure], atol=1e-7)
    got = clf.predict_pvalues(Xt).numpy()
    want = np.asarray(jclf.predict_pvalues(Xt))
    # the candidates' scores, from the p-value's own comparison: a near-tie
    # is a calibration score within tolerance of the candidate's
    if measure == "lssvm":
        f = (clf._phi(_t(Xt)) @ clf._state.w).numpy()
        alpha = -np.array([-1.0, 1.0])[None, :] * f[:, None]
    elif measure == "kde":
        st = clf._state
        alpha = np.stack([icp._kde_scores_against(
            st.X_train, st.y_train, st.class_counts, _t(Xt),
            torch.full((M,), lbl, dtype=torch.int32), h=H, p_dim=P,
            n_labels=labels).numpy()
            for lbl in range(labels)], 1)
    else:
        lab = torch.arange(labels, dtype=torch.int32).expand(M, labels)
        alpha = icp._knn_scores_against(
            clf._state.X_train, clf._state.y_train, _t(Xt), lab, k=K,
            simplified=measure == "simplified_knn").numpy()
    ties = _ties(np.broadcast_to(cal, alpha.shape + cal.shape), alpha,
                 TOL[measure])
    _assert_counts(got, want, cal.shape[0], ties)


@pytest.mark.parametrize("measure,fmap", [("knn", None),
                                          ("simplified_knn", None),
                                          ("kde", None), ("lssvm", "linear"),
                                          ("lssvm", "rff")])
def test_conformal_predictor_matches_jax(measure, fmap):
    """Fit in JAX, carry the state (and the rff map's W, b) across, then
    observe, evict and read on both sides. The k-NN measures fit on each
    side instead: ``decremental_remove`` finds the rows to repair by
    comparing a recomputed distance with the stored k-th one, and a state
    fitted by JAX holds distances one rounding away from the port's, so a
    row whose k-th neighbour leaves could be missed (the same dependence
    behind the reference's own 1-ulp drift in
    ``test_knn_decremental_remove_exact``); their converted state is read
    here before any update."""
    labels = 2 if measure == "lssvm" else LBL
    X, y = _data(N + 2, 14, labels=labels)
    Xt, _ = _data(M, 15, labels=labels)
    hp = {"k": K} if "knn" in measure else {"h": H} if measure == "kde" \
        else {"feature_map": fmap, "rff_dim": 16}
    jcp = jreg.ConformalPredictor(measure, n_labels=labels, **hp)
    jcp.fit(X[:N], y[:N])
    cp = registry.ConformalPredictor(measure, n_labels=labels, device="cpu",
                                     **hp)
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jcp._state)]
    klass = {"kde": kde.KdeState, "lssvm": lssvm.LssvmState}.get(
        measure, knn.KnnState)
    cp._state = convert.batch_state_from_numpy(klass, leaves, device="cpu")
    if klass is knn.KnnState:
        _assert_counts(cp.pvalues(Xt).numpy(), jcp.pvalues(Xt), N,
                       np.zeros((M, labels), bool))
        cp.fit(X[:N], y[:N])
    if measure == "lssvm":
        params = (convert.rff_params_from_numpy(*_jax_rff(P, 16, 0),
                                                device="cpu")
                  if fmap == "rff" else None)
        cp._ctx = lssvm.feature_map(fmap, P, 16, params=params)[0]
    for i in range(N, N + 2):
        jcp.observe(X[i], int(y[i]))
        cp.observe(X[i], int(y[i]))
    for i in (0, 17):
        jcp.evict(i)
        cp.evict(i)
    assert cp.n == jcp.n == N
    tol = TOL[measure]
    for a, b in zip(cp._state.leaves(), jax.tree_util.tree_leaves(
            jcp._state)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=1e-5)
    got, want = cp.pvalues(Xt).numpy(), np.asarray(jcp.pvalues(Xt))
    np.testing.assert_allclose(got, want, atol=2.0 / (N + 1))
    assert (_counts(got, N) == _counts(want, N)).mean() > 0.9
    assert cp.predict_set(Xt, 0.2).shape == (M, labels)


# ---------------------------------------------------------------------------
# exactness inside the port, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_kde_optimized_equals_standard_bitwise(seed):
    X, y = _data(50, seed)
    Xt, _ = _data(4, seed + 1)
    X, y, Xt = _t(X), _t(y), _t(Xt)
    st = kde.fit(X, y, h=H, n_labels=LBL)
    kw = dict(h=H, p_dim=P)
    assert torch.equal(kde.pvalues_optimized(st, Xt, n_labels=LBL, **kw),
                       kde.pvalues_standard(X, y, Xt, n_labels=LBL, **kw))
    for t in range(4):
        for lbl in range(LBL):
            a = kde.scores_optimized(st, Xt[t], lbl, **kw)
            b = kde.scores_standard(X, y, Xt[t], lbl, **kw)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_kde_standard_sums_are_kde_rowsums_over_the_augmented_set():
    from repro_torch.kernels import ref

    X, y = map(_t, _data(40, 21))
    x = _t(_data(1, 22)[0][0])
    Xa = torch.cat([X, x[None]])
    ya = torch.cat([y, torch.tensor([1], dtype=torch.int32)])
    sums = ref.kde_rowsums(Xa, Xa, ya, ya, H, exclude_diag=True)
    n_y = (ya[:, None] == ya[None, :]).sum(1, dtype=torch.int32) - 1
    want = -torch.where(n_y > 0, sums / (n_y * H ** P), 0.0)
    alphas, alpha = kde.scores_standard(X, y, x, 1, h=H, p_dim=P)
    assert torch.equal(alphas, want[:-1]) and torch.equal(alpha, want[-1])


def test_kde_incremental_add_equals_fit_bitwise():
    X, y = map(_t, _data(N, 23))
    st = kde.fit(X[:-3], y[:-3], h=H, n_labels=LBL)
    for i in range(N - 3, N):
        st = kde.incremental_add(st, X[i], int(y[i]), h=H)
    full = kde.fit(X, y, h=H, n_labels=LBL)
    assert all(torch.equal(a, b) for a, b in zip(st.leaves(), full.leaves()))


def _ulps(before, after, want):
    ulp = torch.nextafter(before, torch.full_like(before, float("inf")))
    return (after - want).abs() / (ulp - before)


def test_kde_evict_of_the_added_point_within_4_ulp():
    """Observe, then evict that point: ``class_counts`` exact and
    ``prelim`` within 4 ulp of the pre-removal sums (two roundings: the
    add and the subtraction)."""
    X, y = map(_t, _data(N, 24))
    st = kde.fit(X[:-1], y[:-1], h=H, n_labels=LBL)
    grown = kde.incremental_add(st, X[-1], int(y[-1]), h=H)
    back = kde.decremental_remove(grown, N - 1, h=H)
    assert torch.equal(back.class_counts, st.class_counts)
    assert torch.equal(back.X, st.X) and torch.equal(back.y, st.y)
    assert bool((_ulps(grown.prelim[:-1], back.prelim, st.prelim) <= 4)
                .all())


@pytest.mark.parametrize("i", [0, 9, -1])
def test_kde_decremental_remove_against_refit(i):
    """Removing any point: counts exact; ``prelim`` equal, bit for bit, to
    its own arithmetic (the same-label rows shed the removed point's plain
    kernel value); against a refit within the JAX test's atol 1e-5 and
    within the recursive-summation bound (n + 1 ulp of the pre-removal
    sums; a removed large term takes the small terms it had absorbed with
    it, so bitwise equality with a refit does not hold)."""
    from repro_torch.kernels import ref

    X, y = map(_t, _data(N, 25))
    st = kde.fit(X, y, h=H, n_labels=LBL)
    got = kde.decremental_remove(st, i, h=H)
    j = i % N
    keep = torch.arange(N) != j
    kv = ref.kde_kvals(ref.sq_dists(X[j:j + 1], X), H)[0]
    assert torch.equal(got.prelim, torch.where(y == y[j], st.prelim - kv,
                                               st.prelim)[keep])
    want = kde.fit(X[keep], y[keep], h=H, n_labels=LBL)
    assert torch.equal(got.class_counts, want.class_counts)
    np.testing.assert_allclose(got.prelim.numpy(), want.prelim.numpy(),
                               atol=1e-5)
    assert bool((_ulps(st.prelim[keep], got.prelim, want.prelim) <= N + 1)
                .all())


@pytest.mark.parametrize("k", [1, 4, 9])
def test_knn_incremental_add_equals_fit_bitwise(k):
    X, y = map(_t, _data(N, 30 + k))
    st = knn.fit(X[:-4], y[:-4], k=k)
    for i in range(N - 4, N):
        st = knn.incremental_add(st, X[i], int(y[i]), k=k)
    full = knn.fit(X, y, k=k)
    assert all(torch.equal(a, b) for a, b in zip(st.leaves(), full.leaves()))


@pytest.mark.parametrize("i", [0, 13, -1])
def test_knn_decremental_remove_equals_fit_bitwise(i):
    X, y = map(_t, _data(N, 40))
    got = knn.decremental_remove(knn.fit(X, y, k=K), i, k=K)
    keep = torch.arange(N) != i % N
    want = knn.fit(X[keep], y[keep], k=K)
    assert all(torch.equal(a, b) for a, b in zip(got.leaves(),
                                                  want.leaves()))


@pytest.mark.parametrize("simplified", [False, True])
def test_knn_optimized_equals_standard_pvalues(simplified):
    X, y = map(_t, _data(50, 41))
    Xt = _t(_data(5, 42)[0])
    kw = dict(k=K, simplified=simplified, n_labels=LBL)
    assert torch.equal(knn.pvalues_optimized(knn.fit(X, y, k=K), Xt, **kw),
                       knn.pvalues_standard(X, y, Xt, **kw))


def test_rows_do_not_depend_on_the_batch(monkeypatch):
    """k-NN fit in row blocks of 1, 7 or all rows, and reads of a test
    point alone or inside a larger (or blocked) batch, give the same
    bits."""
    X, y = map(_t, _data(N, 43))
    Xt = _t(_data(9, 44)[0])
    full = knn.fit(X, y, k=K)
    for rows in (1, 7):
        monkeypatch.setattr(knn, "BLOCK_ELEMS", rows * N)
        st = knn.fit(X, y, k=K)
        assert all(torch.equal(a, b) for a, b in zip(st.leaves(),
                                                      full.leaves()))
    monkeypatch.undo()
    kst = kde.fit(X, y, h=H, n_labels=LBL)
    reads = [
        lambda Z: knn.pvalues_optimized(full, Z, k=K, simplified=False,
                                        n_labels=LBL),
        lambda Z: kde.pvalues_optimized(kst, Z, h=H, p_dim=P,
                                        n_labels=LBL)]
    wholes = [read(Xt) for read in reads]
    for read, whole in zip(reads, wholes):
        for t in (0, 4, 8):
            assert torch.equal(read(Xt[t:t + 1]), whole[t:t + 1])
    monkeypatch.setattr(knn, "BLOCK_ELEMS", 2 * LBL * N)  # 2 points a block
    monkeypatch.setattr(kde, "BLOCK_ELEMS", 2 * LBL * N)
    for read, whole in zip(reads, wholes):
        blocked = read(Xt)
        assert torch.equal(blocked, whole)
        assert torch.equal(blocked, torch.cat([read(Xt[t:t + 1])
                                               for t in range(9)]))


def test_lssvm_add_then_remove_round_trips():
    X, y = _data(30, 45, labels=2, p=4)
    Phi, Y = _t(X), _t((2.0 * y - 1.0).astype(np.float32))
    st = lssvm.fit(Phi[:-1], Y[:-1], 1.0)
    grown = lssvm.incremental_add(st, Phi[-1], float(Y[-1]))
    full = lssvm.fit(Phi, Y, 1.0)
    np.testing.assert_allclose(grown.w.numpy(), full.w.numpy(), atol=2e-5)
    np.testing.assert_allclose(grown.C.numpy(), full.C.numpy(), atol=2e-5)
    back = lssvm.decremental_remove(grown, -1)
    np.testing.assert_allclose(back.w.numpy(), st.w.numpy(), atol=2e-5)
    np.testing.assert_allclose(back.C.numpy(), st.C.numpy(), atol=2e-5)
    np.testing.assert_allclose(
        lssvm.decremental_remove_w(grown, Phi[-1], float(Y[-1])).numpy(),
        st.w.numpy(), atol=2e-5)
