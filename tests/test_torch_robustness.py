"""The port's fault harness and tick guard.

* the keyed fault plans, ``corrupt_traffic``, ``backoff_schedule``,
  ``flip_byte`` and the injector equal the JAX package's on the same
  seeds;
* ``TickGuard`` is bit-neutral on clean traffic, and its admission
  rejects exactly the oracle's hits, by kind;
* a poisoned lane stays frozen without a store, and with one is restored
  to the snapshot's lane bitwise, the other lanes untouched;
* the chaos run: the surviving tenants' p-values and state are bitwise a
  clean engine's with the hit lane-ticks gated off; against the JAX
  ``TickGuard`` on the same traffic, p-values within 1e-6 (the
  cross-framework tolerance of ``tests/test_torch_serving.py``) and the
  rejection counts exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import robustness as jrob  # noqa: E402
from repro.regression import RegressionServingEngine as JaxReg  # noqa: E402
from repro.serving import ServingEngine as JaxCls  # noqa: E402
from repro_torch import robustness as trob  # noqa: E402
from repro_torch.regression import RegressionServingEngine  # noqa: E402
from repro_torch.robustness import (VALUE_FAULTS, Fault,  # noqa: E402
                                    FaultInjector, FaultPlan, TickGuard,
                                    corrupt_traffic, poison_state)
from repro_torch.serving import (AsyncShardedSaver, ServingEngine,  # noqa: E402
                                 SessionStore)
from repro_torch.telemetry import MetricsRegistry  # noqa: E402

S, CAP, DIM, K, WIN = 6, 32, 4, 3, 16
MODES = ["classification", "regression"]
KIND_OF = {"nan_feature": "nonfinite_feature",
           "inf_feature": "nonfinite_feature",
           "label_out_of_range": "label_out_of_range",
           "tau_out_of_range": "tau_out_of_range"}


def _mk(mode):
    kw = dict(n_sessions=S, capacity=CAP, dim=DIM, k=K, window=WIN,
              device="cpu")
    if mode == "classification":
        return ServingEngine(n_labels=2, **kw)
    return RegressionServingEngine(**kw)


def _traffic(mode, T, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(T, S, DIM)).astype(np.float32)
    if mode == "classification":
        y = rng.integers(0, 2, size=(T, S)).astype(np.int32)
    else:
        y = rng.normal(size=(T, S)).astype(np.float32)
    taus = rng.uniform(size=(T, S)).astype(np.float32)
    return X, y, taus


def _bytes(state, rows=None):
    out = []
    for t in state.leaves():
        a = t.numpy()
        out.append((a if rows is None else a[rows]).tobytes())
    return out


def _metric_sum(metrics, name):
    return sum(m["value"] for m in metrics.to_dict()["metrics"]
               if m["name"] == name)


# --------------------------------------------------------- the fault harness


def _fields(plan):
    return [(f.site, f.step, f.kind, f.tenant, f.param, f.times)
            for f in plan.faults()]


@pytest.mark.parametrize("seed,rate,kinds,sites", [
    (9, 0.2, VALUE_FAULTS, ("traffic",)),
    (23, 0.06, VALUE_FAULTS + ("duplicate_arrival", "delay"), ("traffic",)),
    (4, 0.3, ("write_fail", "corrupt_shard", "checksum_flip"),
     ("store.write", "store.shard", "store.manifest")),
])
def test_fault_plans_equal_jax(seed, rate, kinds, sites):
    a = FaultPlan.random(seed, steps=96, tenants=5, rate=rate, kinds=kinds,
                         sites=sites, param=0.001, times=2)
    b = jrob.FaultPlan.random(seed, steps=96, tenants=5, rate=rate,
                              kinds=kinds, sites=sites, param=0.001,
                              times=2)
    assert len(a) > 0 and _fields(a) == _fields(b)
    wide = FaultPlan.random(seed, steps=256, tenants=5, rate=rate,
                            kinds=kinds, sites=sites, param=0.001, times=2)
    assert [f for f in wide.faults() if f.step < 96] == a.faults()
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("traffic", 0, "meteor_strike")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("time_axis", [0, 1])
def test_corrupt_traffic_equals_jax(mode, time_axis):
    T = 64
    plan_args = dict(steps=T, tenants=S, rate=0.2, kinds=VALUE_FAULTS)
    arrays = _traffic(mode, T)
    if time_axis == 1:
        arrays = (arrays[0].transpose(1, 0, 2).copy(), arrays[1].T.copy(),
                  arrays[2].T.copy())
    got = [a.copy() for a in arrays]
    want = [a.copy() for a in arrays]
    hits = corrupt_traffic(FaultPlan.random(3, **plan_args), *got,
                           mode=mode, n_labels=2, time_axis=time_axis)
    jhits = jrob.corrupt_traffic(jrob.FaultPlan.random(3, **plan_args),
                                 *want, mode=mode, n_labels=2,
                                 time_axis=time_axis)
    assert hits and hits == jhits
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    assert any(g.tobytes() != a.tobytes() for g, a in zip(got, arrays))


def test_backoff_flip_byte_and_injector_equal_jax(tmp_path):
    for args in [(3, 7, 4, 0.05), (0, 0, 3, 0.01), (11, 2, 5, 1.0)]:
        assert trob.backoff_schedule(*args) == jrob.backoff_schedule(*args)
    blobs = []
    for mod in (trob, jrob):
        p = tmp_path / f"{mod.__name__}.bin"
        p.write_bytes(bytes(range(64)))
        off = mod.flip_byte(str(p), seed=4)
        blobs.append((off, p.read_bytes()))
        mod.flip_byte(str(p), offset=off)
        assert p.read_bytes() == bytes(range(64))
    assert blobs[0] == blobs[1]
    for kind in VALUE_FAULTS:
        for mode in MODES:
            assert repr(trob.poisoned_values(kind, mode=mode)) == \
                repr(jrob.poisoned_values(kind, mode=mode))
    digests = []
    for mod in (trob, jrob):
        metrics = MetricsRegistry()
        plan = mod.FaultPlan(1, (
            mod.Fault("store.write", 5, "write_fail", times=2),
            mod.Fault("store.manifest", 5, "checksum_flip")))
        inj = mod.FaultInjector(plan, metrics=metrics)
        for _ in range(2):
            with pytest.raises(mod.TransientWriteError):
                inj.enter("store.write", 5)
        inj.enter("store.write", 5)
        digests.append(inj.mutate_digest("store.manifest", 5, "ab" * 32))
        assert _metric_sum(metrics, "faults_injected_total") == 3
    assert digests[0] == digests[1] != "ab" * 32


# ------------------------------------------------------------------ the guard


@pytest.mark.parametrize("mode", MODES)
def test_guard_is_bit_neutral_on_clean_traffic(mode):
    X, y, taus = _traffic(mode, 48)
    plain, guarded = _mk(mode), TickGuard(_mk(mode), check_every=1)
    sp, sg = plain.init_state(), guarded.init_state()
    for c in range(3):
        sl = slice(c * 16, (c + 1) * 16)
        sp, pp = plain.observe_many(sp, X[sl], y[sl], taus[sl])
        sg, pg = guarded.observe_many(sg, X[sl], y[sl], taus[sl])
        assert pp.numpy().tobytes() == pg.numpy().tobytes()
    sg = guarded.finalize(sg)
    assert _bytes(sp) == _bytes(sg)
    rep = guarded.drain()
    assert sum(rep["rejected"].values()) == 0
    assert rep["quarantines"] == 0 and rep["quarantined_lanes"] == []


@pytest.mark.parametrize("mode", MODES)
def test_guard_admission_rejects_the_oracle_hits_by_kind(mode):
    T = 32
    X, y, taus = _traffic(mode, T)
    Xc, yc, tc = X.copy(), y.copy(), taus.copy()
    plan = FaultPlan.random(2, steps=T, tenants=S, rate=0.3,
                            kinds=VALUE_FAULTS)
    hits = corrupt_traffic(plan, X, y, taus, mode=mode, n_labels=2)
    mask = np.ones((T, S), dtype=bool)
    want = dict.fromkeys(trob.REJECT_KINDS, 0)
    for f in plan.faults():
        mask[f.step, f.tenant % S] = False
        want[KIND_OF[f.kind]] += 1
    assert all(want.values()), "seed 2 must draw every rejection kind"

    metrics = MetricsRegistry()
    guarded = TickGuard(_mk(mode), metrics=metrics)
    sg, pg = guarded.observe_many(guarded.init_state(), X, y, taus)
    sg = guarded.finalize(sg)
    oracle = _mk(mode)
    so, po = oracle.observe_many(oracle.init_state(), Xc, yc, tc, mask)
    for t, lane in hits:
        assert np.isnan(pg[t, lane].item())
    assert pg.numpy().tobytes() == po.numpy().tobytes()
    assert _bytes(sg) == _bytes(so)
    rep = guarded.drain()
    assert rep["rejected"] == want
    for kind, n in want.items():
        assert metrics.counter("guard_rejected_inputs_total",
                               kind=kind).value == n


def test_guard_freezes_a_poisoned_lane_without_a_store():
    mode, lane = "classification", 2
    X, y, taus = _traffic(mode, 32)
    guard = TickGuard(_mk(mode), check_every=1)
    state, _ = guard.observe_many(guard.init_state(), X[:16], y[:16],
                                  taus[:16])
    state = poison_state(state, lane)
    state = guard.finalize(state)
    rep = guard.drain()
    assert rep["quarantines"] == 1 and rep["restores"] == 0
    assert rep["quarantined_lanes"] == [lane]
    before = [t[lane].clone() for t in state.leaves()]
    state, p = guard.observe_many(state, X[16:], y[16:], taus[16:])
    assert torch.isnan(p[:, lane]).all()
    assert all(torch.equal(a, b) or (torch.isnan(a) == torch.isnan(b)).all()
               and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
               for a, b in zip(before, [t[lane] for t in state.leaves()]))


@pytest.mark.parametrize("mode", MODES)
def test_guard_restores_a_poisoned_lane_from_the_snapshot(tmp_path, mode):
    lane = 3
    X, y, taus = _traffic(mode, 40)
    metrics = MetricsRegistry()
    store = SessionStore(str(tmp_path), metrics=metrics)
    eng, ref = _mk(mode), _mk(mode)
    guard = TickGuard(eng, store=store, metrics=metrics, check_every=1)
    state, _ = guard.observe_many(eng.init_state(), X[:12], y[:12],
                                  taus[:12])
    store.save(12, state, meta=eng.meta(), blocking=True)
    snap_lane = [t[lane].clone() for t in state.leaves()]
    state, _ = guard.observe_many(state, X[12:24], y[12:24], taus[12:24])
    rs, _ = ref.observe_many(ref.init_state(), X[:24], y[:24], taus[:24])
    state = poison_state(state, lane)
    state = guard.finalize(state)
    rep = guard.drain()
    assert rep["quarantines"] == 1 and rep["restores"] == 1
    assert rep["quarantined_lanes"] == []
    assert all(torch.equal(t[lane], v)
               for t, v in zip(state.leaves(), snap_lane))
    keep = [s for s in range(S) if s != lane]
    assert _bytes(state, keep) == _bytes(rs, keep)
    assert _metric_sum(metrics, "guard_restores_total") == 1
    state, p = guard.observe_many(state, X[24:], y[24:], taus[24:])
    assert torch.isfinite(p[:, lane]).all()


def _jax_engine(mode):
    kw = dict(n_sessions=S, capacity=CAP, dim=DIM, k=K, window=WIN)
    if mode == "classification":
        return JaxCls(n_labels=2, **kw)
    return JaxReg(**kw)


@pytest.mark.parametrize("mode", MODES)
def test_chaos_run_survivors_bitwise_and_equal_to_jax(tmp_path, mode):
    """A keyed plan of traffic value faults, one transient write failure
    on a mid-run snapshot and an in-memory lane poison over 224 ticks:
    the surviving tenants are bitwise a fault-free engine on the surviving
    stream; the JAX guard on the same faulted traffic gives the same
    p-values (1e-6) and the same rejection counts."""
    SEED, T, CH = 23, 224, 8
    # chunk 7 starts at ring head 56 % WIN == 8: the poisoned slot 0
    # survives the chunk, so the deferred sweep sees it
    POISON_LANE, POISON_CHUNK = 4, 7
    X, y, taus = _traffic(mode, T)
    Xc, yc, tc = X.copy(), y.copy(), taus.copy()
    plan = FaultPlan.random(SEED, steps=T, tenants=S, rate=0.06,
                            kinds=VALUE_FAULTS)
    hits = corrupt_traffic(plan, X, y, taus, mode=mode, n_labels=2)
    assert len(hits) >= 5
    mask = np.ones((T, S), dtype=bool)
    for t, lane in hits:
        mask[t, lane] = False

    metrics = MetricsRegistry()
    io_plan = FaultPlan(SEED, (Fault("store.write", 3, "write_fail"),))
    store = SessionStore(str(tmp_path), metrics=metrics,
                         injector=FaultInjector(io_plan, metrics=metrics))
    saver = AsyncShardedSaver(store, 2, metrics=metrics, retry_base_s=0.001,
                              seed=SEED)
    eng = _mk(mode)
    guard = TickGuard(eng, store=store, metrics=metrics, check_every=2)
    state = eng.init_state()
    saver.save(0, state, meta=eng.meta())
    saver.wait()
    jguard = jrob.TickGuard(_jax_engine(mode), check_every=2)
    jstate = jguard.init_state()
    oracle = _mk(mode)
    so = oracle.init_state()
    pg, pj, po = [], [], []
    for c in range(T // CH):
        sl = slice(c * CH, (c + 1) * CH)
        if c == POISON_CHUNK:
            state = poison_state(state, POISON_LANE)
        state, p = guard.observe_many(state, X[sl], y[sl], taus[sl])
        pg.append(p.numpy())
        jstate, p = jguard.observe_many(jstate, jnp.asarray(X[sl]),
                                        jnp.asarray(y[sl]),
                                        jnp.asarray(taus[sl]))
        pj.append(np.asarray(p))
        so, p = oracle.observe_many(so, Xc[sl], yc[sl], tc[sl], mask[sl])
        po.append(p.numpy())
        if c == 3:
            saver.save(3, state, meta=eng.meta())
    state = guard.finalize(state)
    saver.close()
    rep, jrep = guard.drain(), jguard.drain()

    keep = [s for s in range(S) if s != POISON_LANE]
    pg, pj, po = np.concatenate(pg), np.concatenate(pj), np.concatenate(po)
    assert pg[:, keep].tobytes() == po[:, keep].tobytes()
    t_poison = POISON_CHUNK * CH
    assert pg[:t_poison].tobytes() == po[:t_poison].tobytes()
    assert _bytes(state, keep) == _bytes(so, keep)
    assert rep["quarantines"] >= 1 and rep["restores"] >= 1
    assert rep["quarantined_lanes"] == []
    assert _metric_sum(metrics, "snapshot_retries_total") == 1
    assert store.latest_step() == 3
    # the JAX guard saw the same faulted traffic (no poison): the same
    # rejections, and the same p-values wherever the poisoned lane's
    # history does not enter
    assert jrep["rejected"] == {
        k: sum(1 for f in plan.faults() if KIND_OF[f.kind] == k)
        for k in trob.REJECT_KINDS}
    assert rep["rejected"] == jrep["rejected"]  # restored at once: live
    np.testing.assert_allclose(pg[:, keep], pj[:, keep], atol=1e-6)
    assert (np.isnan(pg[:, keep]) == np.isnan(pj[:, keep])).all()
