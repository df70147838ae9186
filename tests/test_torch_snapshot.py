"""The port's snapshot store against the JAX package's, on one on-disk
format: a snapshot written by either package restores in the other with
every leaf bitwise equal (the 8-leaf classification, 10-leaf regression
and legacy 5/6-leaf forms); inside the port, a restored engine continues
bitwise; the walk-back, the asynchronous sharded saver's retry and
discard, and the engines' ``reset_occupancy``.
"""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.store import CheckpointStore as JaxStore  # noqa: E402
from repro.regression import RegressionServingEngine as JaxReg  # noqa: E402
from repro.serving import ServingEngine as JaxCls  # noqa: E402
from repro.serving import SessionStore as JaxSessionStore  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.core import engine_utils  # noqa: E402
from repro_torch.regression import RegressionServingEngine  # noqa: E402
from repro_torch.robustness import (Fault, FaultInjector,  # noqa: E402
                                    FaultPlan, flip_byte)
from repro_torch.serving import (AsyncShardedSaver, ServingEngine,  # noqa: E402
                                 SessionStore)
from repro_torch.serving import convert  # noqa: E402

S, CAP, W, DIM = 4, 16, 8, 3
MODES = ["classification", "regression"]


def _traffic(mode, T, seed=0, S=S):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, S, DIM)).astype(np.float32)
    if mode == "classification":
        ys = rng.integers(0, 2, (T, S)).astype(np.int32)
    else:
        ys = rng.standard_normal((T, S)).astype(np.float32)
    taus = rng.random((T, S)).astype(np.float32)
    return xs, ys, taus


def _engines(mode, **kw):
    kw = dict(n_sessions=S, capacity=CAP, dim=DIM, window=W, **kw)
    if mode == "classification":
        return (JaxCls(k=3, **kw, donate=False),
                ServingEngine(k=3, **kw, device="cpu"))
    return (JaxReg(k=3, **kw, donate=False),
            RegressionServingEngine(k=3, **kw, device="cpu"))


def _jax_leaves(state):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(state)]


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert g.tobytes() == w.tobytes(), f"leaf {i}"


def _jax_state(mode, T=20):
    jeng, _ = _engines(mode)
    xs, ys, taus = _traffic(mode, T)
    state, _ = jeng.observe_many(jeng.init_state(), jnp.asarray(xs),
                                 jnp.asarray(ys), jnp.asarray(taus))
    return jeng, state


def _meta_fields(eng):
    return (eng.k, eng.window, eng.capacity, eng.n_sessions, eng.dim,
            str(eng.dtype).removeprefix("torch."),
            isinstance(eng, (JaxReg, RegressionServingEngine)))


def _jax_meta_fields(eng):
    return (eng.k, eng.window, eng.capacity, eng.n_sessions, eng.dim,
            jnp.dtype(eng.dtype).name, isinstance(eng, JaxReg))


@pytest.mark.parametrize("mode", MODES)
def test_jax_snapshot_restores_in_port_bitwise(tmp_path, mode):
    jeng, jstate = _jax_state(mode)
    JaxSessionStore(str(tmp_path)).save(7, jstate, meta=jeng.meta(),
                                        blocking=True)
    eng, state, step = SessionStore(str(tmp_path)).restore_engine(
        device="cpu")
    assert step == 7
    _assert_bitwise(state.leaves(), _jax_leaves(jstate))
    assert _meta_fields(eng) == _jax_meta_fields(jeng)
    assert int(state.head.max()) > 0  # a wrapped ring came across


@pytest.mark.parametrize("mode", MODES)
def test_port_snapshot_restores_in_jax_bitwise(tmp_path, mode):
    jeng0, jstate = _jax_state(mode)
    _, eng = _engines(mode)
    to_port = (convert.session_from_numpy if mode == "classification"
               else convert.reg_state_from_numpy)
    state = to_port(_jax_leaves(jeng0.init_state()), "cpu")
    xs, ys, taus = _traffic(mode, 20)
    state, _ = eng.observe_many(state, xs, ys, taus)
    SessionStore(str(tmp_path)).save(3, state, meta=eng.meta(),
                                     blocking=True)
    jeng, jrestored, step = JaxSessionStore(str(tmp_path)).restore_engine()
    assert step == 3
    want = [t.numpy() for t in state.leaves()]
    _assert_bitwise(_jax_leaves(jrestored), want)
    assert _jax_meta_fields(jeng) == _meta_fields(eng)
    manifest = JaxStore(str(tmp_path)).read_manifest(3)
    assert manifest["treedef"].startswith("repro_torch.")
    assert [s["dtype"] for s in manifest["leaves"]] == [
        str(a.dtype) for a in want]


def _legacy_leaves(form, seed=3):
    """Pre-ring linear snapshot leaves, batched over 2 tenants, with a
    tie-heavy distance matrix (points on a {0, 1} grid): many rows hold
    equal distances across the k-th place, so the rebuilt neighbours'
    arrival ids depend on the tie rule."""
    rng = np.random.default_rng(seed)
    Sx, cap, k, n = 2, 12, 3, np.array([9, 12], np.int32)
    X = rng.integers(0, 2, (Sx, cap, DIM)).astype(np.float32)
    live = np.arange(cap)[None, :] < n[:, None]
    X[~live] = 0.0
    d = np.sqrt(((X[:, :, None] - X[:, None]) ** 2).sum(-1)).astype(
        np.float32)
    D = np.where(live[:, :, None] & live[:, None, :], d, np.float32(1e30))
    D[:, np.arange(cap), np.arange(cap)] = np.float32(1e30)
    if form == 5:
        y = np.where(live, rng.integers(0, 2, (Sx, cap)), -1).astype(
            np.int32)
        best = np.sort(D, -1)[..., :k].astype(np.float32)
        return [X, y, best, n, D]
    y = np.where(live, rng.standard_normal((Sx, cap)), 0.0).astype(
        np.float32)
    nbr_d = np.sort(D, -1)[..., :k].astype(np.float32)
    nbr_y = rng.standard_normal((Sx, cap, k)).astype(np.float32)
    return [X, y, D, nbr_d, nbr_y, n]


@pytest.mark.parametrize("form", [5, 6])
def test_legacy_forms_restore_equal_in_both_packages(tmp_path, form):
    leaves = _legacy_leaves(form)
    meta = {"n_sessions": 2, "capacity": 12, "dim": DIM, "k": 3,
            "window": None, "dtype": "float32"}
    if form == 6:
        meta["mode"] = "regression"
    else:
        meta["n_labels"] = 2
    JaxStore(str(tmp_path)).save(1, leaves, blocking=True, extra=meta)
    _, jstate, _ = JaxSessionStore(str(tmp_path)).restore_engine()
    eng, state, _ = SessionStore(str(tmp_path)).restore_engine(device="cpu")
    want = _jax_leaves(jstate)
    _assert_bitwise(state.leaves(), want)
    if form == 6:
        # the ties are real: the highest index first would differ
        D = leaves[2]
        order = np.argsort(-np.arange(12))
        last_first = order[np.argsort(D[..., order], -1, kind="stable")]
        alt = np.where(np.sort(D, -1)[..., :3] >= 1e30, 0,
                       last_first[..., :3])
        assert not np.array_equal(alt, want[9])
    assert eng.window is None and eng.capacity == 12


@pytest.mark.parametrize("mode", MODES)
def test_restored_engine_continues_bitwise(tmp_path, mode):
    _, eng = _engines(mode)
    xs, ys, taus = _traffic(mode, 32, seed=4)
    state, _ = eng.observe_many(eng.init_state(), xs[:20], ys[:20],
                                taus[:20])
    SessionStore(str(tmp_path)).save(20, state, meta=eng.meta(),
                                     blocking=True)
    eng2, state2, _ = SessionStore(str(tmp_path)).restore_engine(
        device="cpu")
    state, p1 = eng.observe_many(state, xs[20:], ys[20:], taus[20:])
    state2, p2 = eng2.observe_many(state2, xs[20:], ys[20:], taus[20:])
    assert p1.numpy().tobytes() == p2.numpy().tobytes()
    _assert_bitwise(state2.leaves(), [t.numpy() for t in state.leaves()])


def _saved_store(tmp_path, steps, **kw):
    _, eng = _engines("classification")
    xs, ys, taus = _traffic("classification", 10)
    state, _ = eng.observe_many(eng.init_state(), xs, ys, taus)
    store = SessionStore(str(tmp_path), **kw)
    for s in steps:
        store.save(s, state, meta=eng.meta(), blocking=True)
    return store, eng, state


def test_walk_back_after_a_flipped_byte(tmp_path):
    from repro_torch.telemetry import MetricsRegistry

    reg = MetricsRegistry()
    store, eng, state = _saved_store(tmp_path, (1, 2), metrics=reg)
    flip_byte(str(tmp_path / "step_000000002" / "shard_00000.npz"),
              offset=200)
    got, step, meta = store.restore(device="cpu")
    assert step == 1 and meta == eng.meta()
    assert reg.counter("restore_fallback_total").value == 1
    _assert_bitwise(got.leaves(), [t.numpy() for t in state.leaves()])
    with pytest.raises(IOError, match="checksum"):
        store.restore(2, device="cpu")


def test_restore_engine_without_meta_raises(tmp_path):
    _, eng, state = _saved_store(tmp_path, ())
    SessionStore(str(tmp_path)).save(4, state, blocking=True)
    with pytest.raises(ValueError, match="no engine meta"):
        SessionStore(str(tmp_path)).restore_engine(device="cpu")
    with pytest.raises(ValueError, match="no engine meta"):
        JaxSessionStore(str(tmp_path)).restore_engine()


def test_chunked_hash_is_the_file_digest(tmp_path, monkeypatch):
    path = tmp_path / "blob"
    path.write_bytes(np.random.default_rng(0).bytes(10_000))
    monkeypatch.setattr(tstore, "_HASH_CHUNK", 777)
    assert tstore.sha256_file(str(path)) == hashlib.sha256(
        path.read_bytes()).hexdigest()


@pytest.mark.parametrize("shards", [1, 3])
def test_async_saver_equals_a_blocking_save(tmp_path, shards):
    store, eng, state = _saved_store(tmp_path / "a", (5,))
    saver = AsyncShardedSaver(SessionStore(str(tmp_path / "b")), shards)
    saver.save(5, state, meta=eng.meta())
    want = [t.clone() for t in state.leaves()]
    xs, ys, taus = _traffic("classification", 4, seed=9)
    state, _ = eng.observe_many(state, xs, ys, taus)  # in place, meanwhile
    saver.close()
    a, _, meta_a = store.restore(device="cpu")
    b, _, meta_b = SessionStore(str(tmp_path / "b")).restore(device="cpu")
    assert meta_a == meta_b
    _assert_bitwise(b.leaves(), [t.numpy() for t in want])
    _assert_bitwise(a.leaves(), [t.numpy() for t in want])


def test_async_saver_retries_a_transient_write_fault(tmp_path):
    from repro_torch.telemetry import MetricsRegistry

    reg = MetricsRegistry()
    plan = FaultPlan(0, (Fault("store.write", 6, "write_fail", times=2),))
    store = SessionStore(str(tmp_path),
                         injector=FaultInjector(plan, metrics=reg))
    _, eng, state = _saved_store(tmp_path / "x", ())
    saver = AsyncShardedSaver(store, 2, metrics=reg, retry_base_s=0.001)
    saver.save(6, state, meta=eng.meta())
    saver.close()
    assert reg.counter("snapshot_retries_total").value == 2
    assert store.latest_step() == 6


def test_async_saver_permanent_fault_discards_and_surfaces(tmp_path):
    from repro_torch.telemetry import MetricsRegistry

    reg = MetricsRegistry()
    plan = FaultPlan(0, (Fault("store.commit", 8, "write_fail", times=-1),))
    store = SessionStore(str(tmp_path), injector=FaultInjector(plan))
    _, eng, state = _saved_store(tmp_path / "x", ())
    saver = AsyncShardedSaver(store, 1, metrics=reg, retry_base_s=0.001)
    saver.save(8, state, meta=eng.meta())
    with pytest.raises(RuntimeError, match="async snapshot save failed"):
        saver.wait()
    assert reg.counter("snapshot_failed_steps_total").value == 1
    assert store.latest_step() is None
    assert not any(p.name.startswith("step_") for p in tmp_path.iterdir())
    saver.close()


@pytest.mark.parametrize("mode", MODES)
def test_reset_occupancy_rearms_the_window_check(mode):
    _, eng = _engines(mode)
    xs, ys, taus = _traffic(mode, 4)
    state, _ = eng.observe_many(eng.init_state(), xs, ys, taus)
    bad = state.clone()
    bad.wrap.fill_(CAP)  # a modulus this sliding engine cannot serve
    assert eng._w_checked  # checked once, on the engine's own state
    engine_utils.check_window_occupancy(eng, bad)  # so this one passes
    eng.reset_occupancy()
    with pytest.raises(ValueError, match="ring modulus"):
        eng.observe(bad, xs[0], ys[0], taus[0])
    # grow mode: the occupancy bound is read again from the state
    geng = type(eng)(n_sessions=S, capacity=4, dim=DIM, k=3, device="cpu")
    gstate, _ = geng.observe_many(geng.init_state(), xs, ys, taus)
    assert geng._n_bound == 4
    geng.reset_occupancy()
    assert geng._n_bound is None and not geng._w_checked
    gstate, _ = geng.observe(gstate, xs[0], ys[0], taus[0])
    assert geng._n_bound == 5 and geng.capacity == 8


def test_restore_engine_and_fleet_default_to_cuda(tmp_path):
    """Like every entry point of the port: ``cuda`` unless asked, and a
    raise without a card."""
    from repro_torch.serving import Fleet

    _saved_store(tmp_path, (0,))
    entry_points = {
        "restore_engine": lambda: SessionStore(
            str(tmp_path)).restore_engine()[1].D.device,
        "fleet": lambda: Fleet(dim=DIM, k=3).device,
    }
    for name, make in entry_points.items():
        if torch.cuda.is_available():
            assert make().type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
