"""The port's serving slice against the JAX ``ServingEngine``.

Both engines start from one state (carried across by
``repro_torch.serving.convert``) and get the same numpy ``xs, ys, taus,
active``. Tolerances: ``(T, S)`` and ``predict`` p-values 1e-6 (equality
in practice: a flipped comparison moves a p-value by at least 1/(n+1));
float leaves 1e-5 (the two frameworks sum distances in different
orders); integer leaves exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import online as jonline  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.core import online as tonline  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import convert  # noqa: E402

S, DIM, K, T = 3, 4, 3, 40
INT_LEAVES = (1, 3, 5, 6, 7)  # y, n, head, aid, wrap


def _traffic(seed, T=T, S=S, dim=DIM, ragged=True):
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, 2, (T, S)).astype(np.int32)
    xs = (rng.standard_normal((T, S, dim)) + ys[..., None]).astype(np.float32)
    taus = rng.random((T, S)).astype(np.float32)
    active = rng.random((T, S)) < 0.8 if ragged else np.ones((T, S), bool)
    return xs, ys, taus, active


def _assert_leaves(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, i
        if i in INT_LEAVES:
            np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                       err_msg=f"leaf {i}")


def _run_both(kw, xs, ys, taus, active, chunks):
    jeng = JaxEngine(**kw, donate=False)
    teng = ServingEngine(**kw, device="cpu")
    jstate = jeng.init_state()
    tstate = convert.session_from_numpy(
        [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)], "cpu")
    jps, tps = [], []
    for lo, hi in chunks:
        jstate, jp = jeng.observe_many(
            jstate, jnp.asarray(xs[lo:hi]), jnp.asarray(ys[lo:hi]),
            jnp.asarray(taus[lo:hi]), jnp.asarray(active[lo:hi]))
        tstate, tp = teng.observe_many(tstate, xs[lo:hi], ys[lo:hi],
                                       taus[lo:hi], active[lo:hi])
        jps.append(np.asarray(jp))
        tps.append(tp.numpy())
    return jeng, jstate, teng, tstate, np.concatenate(jps), np.concatenate(tps)


@pytest.mark.parametrize("mode", ["sliding", "grow"])
def test_engine_matches_jax_engine(mode):
    kw = dict(n_sessions=S, capacity=16 if mode == "sliding" else 4,
              dim=DIM, k=K, n_labels=2,
              window=12 if mode == "sliding" else None)
    xs, ys, taus, active = _traffic(1 if mode == "sliding" else 2)
    chunks = [(0, 7), (7, 8), (8, 25), (25, T)]
    jeng, jstate, teng, tstate, jp, tp = _run_both(kw, xs, ys, taus, active,
                                                   chunks)
    np.testing.assert_allclose(tp, jp, atol=1e-6)
    assert np.isnan(tp[~active]).all() and not np.isnan(tp[active]).any()
    assert teng.capacity == jeng.capacity
    if mode == "sliding":
        # the ring wrapped: heads moved past the start of the block
        assert (convert.session_to_numpy(tstate)[5] > 0).any()
    else:
        assert teng.capacity > 4  # capacity doubled at least once
    _assert_leaves(convert.session_to_numpy(tstate),
                   [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)])

    # predict: (S, m, L) p-values, per-tenant queries and a shared batch
    rng = np.random.default_rng(7)
    Xq = rng.standard_normal((S, 5, DIM)).astype(np.float32)
    np.testing.assert_allclose(
        teng.predict(tstate, Xq).numpy(),
        np.asarray(jeng.predict(jstate, jnp.asarray(Xq))), atol=1e-6)
    np.testing.assert_allclose(
        teng.predict(tstate, Xq[0]).numpy(),
        np.asarray(jeng.predict(jstate, jnp.asarray(Xq[0]))), atol=1e-6)


def test_predict_with_rare_label_matches_jax():
    """A label rarer than k leaves BIG-padded lists: those rows take the
    caller-side count in both engines."""
    kw = dict(n_sessions=2, capacity=16, dim=DIM, k=K, n_labels=2,
              window=12)
    xs, ys, taus, active = _traffic(3, T=20, S=2, ragged=False)
    ys[:, :] = 0
    ys[3, 0] = ys[9, 1] = 1  # one point of label 1 per tenant
    jeng, jstate, teng, tstate, jp, tp = _run_both(
        kw, xs, ys, taus, active, [(0, 20)])
    np.testing.assert_allclose(tp, jp, atol=1e-6)
    Xq = np.random.default_rng(4).standard_normal((2, 6, DIM)).astype(
        np.float32)
    np.testing.assert_allclose(
        teng.predict(tstate, Xq).numpy(),
        np.asarray(jeng.predict(jstate, jnp.asarray(Xq))), atol=1e-6)


def test_run_stream_matches_jax():
    rng = np.random.default_rng(5)
    y = rng.integers(0, 2, T).astype(np.int32)
    X = (rng.standard_normal((T, DIM)) + y[:, None]).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want_p, want_m = jonline.run_stream(jnp.asarray(X), jnp.asarray(y), k=K,
                                        key=key, capacity=T)
    taus = np.array(jax.random.uniform(key, (T,), dtype=jnp.float32))
    got_p, got_m = tonline.run_stream(X, y, k=K, taus=taus, device="cpu")
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-6)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                               atol=1e-4, rtol=1e-5)


def test_launcher_serves_sessions_on_cpu(capsys):
    from repro_torch.launch import serve

    rc = serve.main(["--sessions", "4", "--steps", "30", "--window", "12",
                     "--capacity", "16", "--dim", "4", "--k", "3",
                     "--queries", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "session-steps/s" in out and "drift flags" in out
    assert "p-values (4, 5, 2), finite True" in out


def test_convert_round_trip_and_meta():
    eng = ServingEngine(n_sessions=S, capacity=16, dim=DIM, k=K, window=12,
                        device="cpu")
    state = eng.init_state()
    xs, ys, taus, active = _traffic(6, T=20)
    state, _ = eng.observe_many(state, xs, ys, taus, active)
    leaves = convert.session_to_numpy(state)
    back = convert.session_to_numpy(convert.session_from_numpy(leaves, "cpu"))
    for a, b in zip(leaves, back):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    eng2 = ServingEngine.from_meta(eng.meta(), device="cpu")
    assert eng2.meta() == eng.meta()
    jeng = JaxEngine.from_meta(eng.meta())
    assert ServingEngine.from_meta(jeng.meta(), device="cpu").meta() == \
        eng.meta()
