"""The port's fleet (capacity-bucketed engine pools) against a dedicated
one-lane port engine, bitwise, and against the JAX ``Fleet``.

A tenant served through the fleet, across bucket migrations, lane reuse
after retirement and ragged activity, gives the same p-values and reads
as a dedicated one-lane engine fed the same points: a repad only appends
inert fill. Against the JAX fleet on the same traffic: p-values within
1e-6 and interval endpoints within 1e-5 (the cross-framework tolerances
of ``tests/test_torch_serving.py``: a flipped comparison moves a p-value
by at least 1/(n+1); the frameworks sum distances in different orders);
the repad functions and the cost model's buckets exactly.
"""
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.regression import RegressionServingEngine as JaxReg  # noqa: E402
from repro.serving import Fleet as JaxFleet  # noqa: E402
from repro.serving import ServingEngine as JaxCls  # noqa: E402
from repro.serving import fleet as jfleet  # noqa: E402
from repro.telemetry.costmodel import CostModel as JaxCostModel  # noqa: E402
from repro_torch.regression import RegressionServingEngine  # noqa: E402
from repro_torch.serving import Fleet, ServingEngine, convert  # noqa: E402
from repro_torch.serving import fleet as tfleet  # noqa: E402
from repro_torch.telemetry import (CostModel,  # noqa: E402
                                   MetricsRegistry, Tracer, fit_cost_model)

D, K = 3, 3
MODES = ["classification", "regression"]


def _streams(rng, tids, T, mode):
    out = {}
    for t in tids:
        x = rng.normal(size=(T, D)).astype(np.float32)
        if mode == "classification":
            y = rng.integers(0, 3, size=T).astype(np.int32)
        else:
            y = rng.normal(size=T).astype(np.float32)
        out[t] = (x, y, rng.uniform(size=T).astype(np.float32))
    return out


def _ref_engine(mode):
    kw = dict(n_sessions=1, capacity=8, dim=D, k=K, window=None,
              device="cpu")
    if mode == "classification":
        return ServingEngine(n_labels=3, **kw)
    return RegressionServingEngine(**kw)


@pytest.mark.parametrize("lo,hi", [(8, 64), (8, 8), (8, 100), (32, 1024)])
def test_pow2_buckets_equal_jax(lo, hi):
    assert tfleet.pow2_buckets(lo, hi) == jfleet.pow2_buckets(lo, hi)


def _wrapped(mode):
    """A wrapped sliding-window JAX state (S 3, cap 16, window 12) and
    its leaves as numpy arrays."""
    S, cap, W = 3, 16, 12
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(30, S, D)).astype(np.float32)
    ys = (rng.integers(0, 3, (30, S)).astype(np.int32)
          if mode == "classification"
          else rng.normal(size=(30, S)).astype(np.float32))
    taus = rng.uniform(size=(30, S)).astype(np.float32)
    kw = dict(n_sessions=S, capacity=cap, dim=D, k=K, window=W)
    jeng = JaxCls(n_labels=3, **kw) if mode == "classification" \
        else JaxReg(**kw)
    js, _ = jeng.observe_many(jeng.init_state(), jnp.asarray(xs),
                              jnp.asarray(ys), jnp.asarray(taus))
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(js)]
    assert (leaves[5 if mode == "classification" else 6] > 0).any()
    return js, leaves


def _port_state(mode, leaves):
    if mode == "classification":
        return convert.session_from_numpy(leaves, "cpu")
    return convert.reg_state_from_numpy(leaves, "cpu")


def _same_leaves(got, want):
    wl = [np.asarray(a) for a in jax.tree_util.tree_leaves(want)]
    assert len(got.leaves()) == len(wl)
    for i, (g, w) in enumerate(zip(got.leaves(), wl)):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert g.tobytes() == w.tobytes(), f"leaf {i}"


@pytest.mark.parametrize("new_cap", [24, 32])
@pytest.mark.parametrize("mode", MODES)
def test_repad_equals_jax_bitwise(mode, new_cap):
    """One lane of a wrapped sliding-window state, repadded by each
    package."""
    js, leaves = _wrapped(mode)
    lane = 1
    jlane = jax.tree_util.tree_map(lambda a: a[lane], js)
    jrepad = jfleet.repad_cls if mode == "classification" else \
        jfleet.repad_reg
    trepad = tfleet.repad_cls if mode == "classification" else \
        tfleet.repad_reg
    want = jax.tree_util.tree_map(lambda a: a[None],
                                  jrepad(jlane, new_cap))
    got = trepad(_port_state(mode, [a[lane:lane + 1] for a in leaves]),
                 new_cap)
    _same_leaves(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_grow_is_repad_to_a_multiple_and_equals_jax(mode):
    """``grow(s, 2)`` == ``repad(s, 2 * cap)`` == the JAX ``grow`` on
    every tenant of a wrapped state, bitwise."""
    from repro.regression import session as jreg_sess
    from repro.serving import session as jcls_sess
    from repro_torch.regression import session as treg_sess
    from repro_torch.serving import session as tcls_sess

    js, leaves = _wrapped(mode)
    jm, tm = ((jcls_sess, tcls_sess) if mode == "classification"
              else (jreg_sess, treg_sess))
    st = _port_state(mode, leaves)
    got = tm.grow(st, 2)
    _same_leaves(got, jax.vmap(lambda one: jm.grow(one, 2))(js))
    assert all(torch.equal(a, b) for a, b in
               zip(got.leaves(), tm.repad(st, 2 * st.capacity).leaves()))


@pytest.mark.parametrize("mode", MODES)
def test_fleet_tenant_equals_a_dedicated_engine_bitwise(mode):
    rng = np.random.default_rng(1)
    tids = [f"t{i}" for i in range(5)]
    T = 40  # the always-active tenant crosses 8 -> 16 -> 32 -> 64
    metrics = MetricsRegistry()
    fleet = Fleet(dim=D, k=K, n_labels=3, mode=mode, cap_min=8,
                  cap_max=64, pool_sessions=2, metrics=metrics,
                  device="cpu")
    for t in tids:
        fleet.admit(t)
    refs = {t: _ref_engine(mode) for t in tids}
    ref_state = {t: refs[t].init_state() for t in tids}
    streams = _streams(rng, tids, T, mode)
    for step in range(T):
        items = {}
        for i, t in enumerate(tids):
            if step % (i + 1) == 0:
                x, y, tau = streams[t]
                n = fleet.occupancy(t)
                items[t] = (x[n], y[n], tau[n])
        ps = fleet.observe(items)
        for t, (xx, yy, tt) in items.items():
            ref_state[t], pref = refs[t].observe(ref_state[t], xx[None],
                                                 [yy], [tt])
            assert ps[t].numpy().tobytes() == pref[0].numpy().tobytes(), t
    Xq = rng.normal(size=(2, D)).astype(np.float32)
    for t in tids:
        if mode == "classification":
            a = fleet.predict(t, Xq)
            b = refs[t].predict(ref_state[t], Xq)[0]
        else:
            a = fleet.intervals(t, Xq, 0.1)
            b = refs[t].intervals(ref_state[t], Xq, 0.1)[0]
            assert fleet.pvalues(t, Xq, [0.0, 1.0]).numpy().tobytes() == \
                refs[t].pvalues(ref_state[t], Xq, [0.0, 1.0])[0] \
                .numpy().tobytes()
        assert a.numpy().tobytes() == b.numpy().tobytes(), t
    assert metrics.counter("fleet_migrations_total", mode=mode).value >= 3
    assert fleet.occupancy(tids[0]) == T
    st = fleet.stats()
    assert st["tenants"] == len(tids) and st["buckets"] == [8, 16, 32, 64]
    assert sum(p["lanes_used"] for p in st["pools"]) == len(tids)


@pytest.mark.parametrize("mode", MODES)
def test_fleet_equals_the_jax_fleet(mode):
    rng = np.random.default_rng(3)
    tids = [f"t{i}" for i in range(4)]
    T = 36
    kw = dict(dim=D, k=K, n_labels=3, mode=mode, cap_min=8, cap_max=32,
              pool_sessions=3)
    fleet, jf = Fleet(**kw, device="cpu"), JaxFleet(**kw)
    for t in tids:
        fleet.admit(t)
        jf.admit(t)
    streams = _streams(rng, tids, T, mode)
    got, want = [], []
    for step in range(T):
        items = {t: tuple(a[fleet.occupancy(t)] for a in streams[t])
                 for i, t in enumerate(tids) if step % (i + 1) == 0}
        if step == 20:  # retire and readmit one tenant mid-stream
            fleet.retire("t1")
            jf.retire("t1")
            fleet.admit("t1")
            jf.admit("t1")
        ps, jps = fleet.observe(items), jf.observe(items)
        for t in items:
            got.append(float(ps[t]))
            want.append(float(jps[t]))
        assert fleet.occupancy("t0") == jf.occupancy("t0")
    np.testing.assert_allclose(got, want, atol=1e-6)
    Xq = rng.normal(size=(3, D)).astype(np.float32)
    for t in tids:
        if mode == "classification":
            a, b = fleet.predict(t, Xq), jf.predict(t, jnp.asarray(Xq))
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        else:
            a, b = fleet.intervals(t, Xq, 0.2), jf.intervals(
                t, jnp.asarray(Xq), 0.2)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)
    assert fleet.stats()["pools"] == jf.stats()["pools"]


def test_retire_readmit_gives_a_fresh_lane():
    rng = np.random.default_rng(2)
    fleet = Fleet(dim=D, k=K, n_labels=3, cap_min=8, cap_max=32,
                  pool_sessions=2, device="cpu")
    fleet.admit("a")
    fleet.admit("b")
    (x, y, tau), = _streams(rng, ["a"], 12, "classification").values()
    for i in range(12):  # past a migration: the lane came back to 8
        fleet.observe({"a": (x[i], y[i], tau[i])})
    fleet.retire("a")
    with pytest.raises(KeyError):
        fleet.occupancy("a")
    with pytest.raises(KeyError):
        fleet.admit("b")
    fleet.admit("c")
    assert fleet.occupancy("c") == 0
    ref = _ref_engine("classification")
    _, rp = ref.observe(ref.init_state(), x[0][None], y[:1], tau[:1])
    p = fleet.observe({"c": (x[0], y[0], tau[0])})
    assert p["c"].numpy().tobytes() == rp[0].numpy().tobytes()


@pytest.mark.parametrize("mode", MODES)
def test_guarded_fleet_rejects_malformed_items(mode):
    rng = np.random.default_rng(5)
    metrics = MetricsRegistry()
    kw = dict(dim=D, k=K, n_labels=3, mode=mode, cap_min=8, cap_max=16,
              pool_sessions=4, guard=True)
    fleet = Fleet(**kw, metrics=metrics, device="cpu")
    plain = Fleet(**{**kw, "guard": False}, device="cpu")
    jf = JaxFleet(**kw)
    for f in (fleet, plain, jf):
        f.admit("a")
        f.admit("b")
    (x, y, tau), = _streams(rng, ["a"], 10, mode).values()
    bad_y = 3 if mode == "classification" else np.float32("inf")
    bads = [(np.full(D, np.nan, np.float32), y[0], tau[0]),
            (x[0], bad_y, tau[0]), (x[0], y[0], 1.5),
            (np.full(D, np.inf, np.float32), y[0], tau[0])]
    for i in range(10):
        items = {"a": (x[i], y[i], tau[i])}
        if i < len(bads):
            items["b"] = bads[i]
        ps, jps = fleet.observe(items), jf.observe(items)
        pp = plain.observe({"a": items["a"]})
        assert ps["a"].numpy().tobytes() == pp["a"].numpy().tobytes()
        if "b" in items:
            assert torch.isnan(ps["b"]) and np.isnan(float(jps["b"]))
        np.testing.assert_allclose(float(ps["a"]), float(jps["a"]),
                                   atol=1e-6)
    assert fleet.occupancy("b") == 0 and fleet.occupancy("a") == 10
    assert metrics.counter("fleet_rejected_observes_total",
                           mode=mode).value == len(bads)


def _trace_records():
    """Steady trace records of port engines at three capacities."""
    f = io.StringIO()
    tr = Tracer(f)
    rng = np.random.default_rng(0)
    for cap in (16, 32, 64):
        eng = ServingEngine(n_sessions=2, capacity=cap, dim=D, k=K,
                            window=cap, instrument=True,
                            metrics=MetricsRegistry(), tracer=tr,
                            device="cpu")
        state = eng.init_state()
        for T in (1, 2, 4, 8, 1, 2, 4, 8):
            xs = rng.normal(size=(T, 2, D)).astype(np.float32)
            state, _ = eng.observe_many(state, xs, np.zeros((T, 2)),
                                        np.full((T, 2), 0.5))
    return [json.loads(line) for line in f.getvalue().splitlines()]


def test_buckets_from_a_fitted_cost_model_equal_jax():
    recs = _trace_records()
    model = fit_cost_model(recs, source="port")
    jmodel = JaxCostModel.fit(recs, source="port")
    assert model.to_json() == jmodel.to_json()
    for cap_min, cap_max, ratio in [(8, 64, 2.0), (32, 1024, 1.5),
                                    (16, 4096, 3.0)]:
        kw = dict(cap_min=cap_min, cap_max=cap_max, cost_ratio=ratio)
        want = jmodel.suggest_buckets(engine="classification", **kw)
        assert model.suggest_buckets(engine="classification", **kw) == want
        f = Fleet(dim=D, k=K, cost_model=model, device="cpu", **kw)
        jf = JaxFleet(dim=D, k=K, cost_model=jmodel, **kw)
        assert f.buckets == jf.buckets == want
    assert model.suggest_chunk(cap_bucket=32) == \
        jmodel.suggest_chunk(cap_bucket=32)
    lin = {("classification", "observe_many", c):
           {"a": 1e-4, "b": 1e-6 * c, "n": 8.0} for c in (64, 256, 1024)}
    assert Fleet(dim=D, k=K, cap_min=8, cap_max=64, device="cpu",
                 cost_model=CostModel(lin)).buckets == \
        tfleet.pow2_buckets(8, 64)

