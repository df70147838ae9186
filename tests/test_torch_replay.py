"""Trace replay and load generation in the port (``repro_torch.telemetry.
{loadgen,replay}``, ``launch.serve --replay``) against the JAX package.

* ``loadgen.generate`` gives records equal to the JAX generator's, dict
  for dict, for every workload and engine, with and without an SLO and a
  ``FaultPlan``;
* the port's ``replay`` reports the JAX replay's counters on the same
  records and seed, and ends in the same state (integers exact, floats
  within the fleet tests' tolerances) with the same reads;
* inside the port, bitwise: twice == twice, chunked == unchunked, shed ==
  unshed, deduplicated == never-duplicated, sharded == unsharded, replay
  == the engine driven directly with ``observe_many``;
* ``calibrate_engine``'s records validate in both packages, and the cost
  models both fit on them suggest the same chunk;
* the launcher's replay mode end to end, and the refusals.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.robustness import FaultPlan as JFaultPlan
from repro.telemetry import CostModel as JCostModel
from repro.telemetry import loadgen as jloadgen
from repro.telemetry import replay as jreplay
from repro.telemetry import validate_trace_file as jvalidate
from repro_torch.regression import RegressionServingEngine
from repro_torch.robustness import VALUE_FAULTS, FaultPlan
from repro_torch.serving import ServingEngine
from repro_torch.telemetry import (CostModel, calibrate_engine, loadgen,
                                   replay, validate_trace_file, write_trace)

S, CAP, DIM, K = 8, 32, 8, 3
GEO = dict(tenants=S, capacity=CAP)
ENG = dict(dim=DIM, k=K, capacity=CAP, window=CAP // 2)
KINDS = VALUE_FAULTS + ("duplicate_arrival", "delay")


def _plan(cls, seed=7, steps=256, rate=0.05):
    return cls.random(seed, steps=steps, tenants=S, rate=rate, kinds=KINDS,
                      param=0.002)


def _leaves(state):
    """A port state's or a JAX state's leaves as numpy arrays."""
    if hasattr(state, "leaves"):
        return [t.numpy() for t in state.leaves()]
    return [np.asarray(t) for t in jax.tree_util.tree_leaves(state)]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.leaves(), b.leaves()))


def _replay(recs, **kw):
    return replay(recs, **ENG, seed=3, device="cpu", **kw)


# ----------------------------------------------------------------- loadgen


@pytest.mark.parametrize("variant", ["plain", "slo", "faults"])
@pytest.mark.parametrize("engine", ["classification", "regression"])
@pytest.mark.parametrize("workload", loadgen.WORKLOADS)
def test_loadgen_equals_jax(workload, engine, variant):
    kw = dict(ops=200, engine=engine, seed=5, predict_every=9, **GEO)
    jkw, tkw = dict(kw), dict(kw)
    if variant == "slo":
        jkw["slo_s"] = tkw["slo_s"] = 0.05
    if variant == "faults":
        jkw["faults"], tkw["faults"] = _plan(JFaultPlan), _plan(FaultPlan)
    want = jloadgen.generate(workload, **jkw)
    got = loadgen.generate(workload, **tkw)
    assert got == want
    if variant == "faults":
        assert any("fault" in r for r in got)
        assert any("delay_s" in r for r in got)


def test_loadgen_plan_changes_only_the_stamped_fields():
    clean = loadgen.generate("bursty", ops=200, seed=5, **GEO)
    recs = loadgen.generate("bursty", ops=200, seed=5, faults=_plan(
        FaultPlan), **GEO)
    for a, b in zip(clean, recs):
        assert a == {k: v for k, v in b.items()
                     if k not in ("fault", "delay_s")}
    for r in recs:
        if r.get("fault", {}).get("kind") == "duplicate_arrival":
            assert r["fault"]["of_seq"] < r["seq"]


# ------------------------------------------------------- replay against JAX

REPORT_KEYS = ("engine", "tenants", "capacity", "window", "ops_replayed",
               "ops_skipped", "ticks", "session_steps", "shards",
               "shed_ops", "deferred_observes", "duplicates_dropped")

CASES = {
    # name: (engine, workload, replay kwargs, stamp a fault plan)
    "class-steady": ("classification", "steady", {}, False),
    "class-bursty-shed-chunk": ("classification", "bursty",
                                dict(chunk=4, shed_depth=6, defer_flush=8),
                                False),
    "class-zipf-shards-guard": ("classification", "zipf",
                                dict(shards=2, guard=True), True),
    "reg-steady-chunk-guard": ("regression", "steady",
                               dict(chunk=5, guard=True), True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def both(request):
    engine, workload, kw, faults = CASES[request.param]
    recs = {}
    for pkg, gen, plan in (("jax", jloadgen, JFaultPlan),
                           ("torch", loadgen, FaultPlan)):
        recs[pkg] = gen.generate(
            workload, ops=96, engine=engine, seed=4, predict_every=11,
            faults=_plan(plan, steps=96, rate=0.08) if faults else None,
            **GEO)
    assert recs["jax"] == recs["torch"]
    j = jreplay(recs["jax"], engine=engine, **ENG, seed=3, **kw)
    t = replay(recs["torch"], engine=engine, **ENG, seed=3, device="cpu",
               **kw)
    return engine, kw, j, t


def test_replay_report_counters_equal_jax(both):
    engine, kw, j, t = both
    for key in REPORT_KEYS:
        assert t.report[key] == j.report[key], key
    assert t.report["per_shard"] == j.report["per_shard"]
    assert set(t.report["per_op"]) == set(j.report["per_op"])
    for op, d in t.report["per_op"].items():
        assert d["count"] == j.report["per_op"][op]["count"]
    if kw.get("guard"):
        assert t.report["guard"] == j.report["guard"]
        assert sum(t.report["guard"]["rejected"].values()) > 0
    if "shed_depth" in kw:
        assert t.report["shed_ops"] > 0 and t.report["deferred_observes"] > 0


def test_replay_state_matches_jax(both):
    engine, _, j, t = both
    tol = (dict(atol=1e-6, rtol=0) if engine == "classification"
           else dict(atol=1e-5, rtol=1e-5))
    for a, b in zip(_leaves(t.state), _leaves(j.state)):
        assert a.shape == b.shape
        if np.issubdtype(b.dtype, np.integer):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **tol)


def test_replay_reads_match_jax(both):
    """The read of every shard's engine on its slice of the state."""
    engine, kw, j, t = both
    shards = kw.get("shards", 1)
    t_engs = t.engine if shards > 1 else [t.engine]
    j_engs = j.engine if shards > 1 else [j.engine]
    xq = np.random.default_rng(11).standard_normal((3, DIM)).astype(
        np.float32)
    for si, (te, je) in enumerate(zip(t_engs, j_engs)):
        lo, hi = S * si // shards, S * (si + 1) // shards
        ts = type(t.state).from_leaves([v[lo:hi] for v in t.state.leaves()])
        js = jax.tree_util.tree_map(lambda v: v[lo:hi], j.state)
        if engine == "classification":
            got = te.predict(ts, xq).numpy()
            want = np.asarray(je.predict(js, xq))
        else:
            got = te.intervals(ts, xq, 0.2).numpy()
            want = np.asarray(je.intervals(js, xq, 0.2))
        np.testing.assert_allclose(got, want, atol=1e-6 if engine ==
                                   "classification" else 1e-5, rtol=0)


# ------------------------------------------------- bitwise inside the port


@pytest.fixture(scope="module")
def bursty():
    return loadgen.generate("bursty", ops=160, seed=5, predict_every=8,
                            **GEO)


@pytest.fixture(scope="module")
def bursty_replayed(bursty):
    return _replay(bursty)


def test_replay_twice_is_bitwise(bursty, bursty_replayed):
    again = _replay(bursty)
    assert _equal(again.state, bursty_replayed.state)
    for key in ("ops_replayed", "ticks", "session_steps"):
        assert again.report[key] == bursty_replayed.report[key]


@pytest.mark.parametrize("chunk", [2, 8, 64])
def test_replay_chunking_is_bitwise_neutral(bursty, bursty_replayed, chunk):
    assert _equal(_replay(bursty, chunk=chunk).state, bursty_replayed.state)


def test_replay_seed_changes_traffic(bursty, bursty_replayed):
    other = replay(bursty, **ENG, seed=4, device="cpu")
    assert not _equal(other.state, bursty_replayed.state)


@pytest.mark.parametrize("depth", [1, 4])
def test_replay_shed_equals_unshed(bursty, bursty_replayed, depth):
    shed = _replay(bursty, shed_depth=depth, defer_flush=8)
    assert shed.report["shed_ops"] > 0
    assert shed.report["deferred_observes"] > 0
    assert _equal(shed.state, bursty_replayed.state)


def test_replay_timed_shed_equals_unshed(bursty, bursty_replayed):
    shed = _replay(bursty, speedup=50.0, shed_depth=2, slo_s=1e-3)
    assert _equal(shed.state, bursty_replayed.state)
    assert 0.0 <= shed.report["slo_violation_frac"] <= 1.0


def test_replay_dedup_equals_never_duplicated():
    plan = _plan(FaultPlan, steps=160, rate=0.1)
    recs = loadgen.generate("steady", ops=160, seed=2,
                            faults=FaultPlan(plan.seed, [
                                f for f in plan.faults()
                                if f.kind == "duplicate_arrival"]), **GEO)
    dups = [r for r in recs
            if r.get("fault", {}).get("kind") == "duplicate_arrival"]
    assert dups
    res = _replay(recs)
    assert res.report["duplicates_dropped"] == len(dups)
    never = _replay([r for r in recs if r not in dups])
    assert _equal(res.state, never.state)
    assert res.metrics.counter("replay_duplicates_dropped_total").value \
        == len(dups)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("engine", ["classification", "regression"])
def test_replay_sharded_equals_unsharded(engine, shards):
    recs = loadgen.generate("zipf", ops=96, engine=engine, seed=6,
                            predict_every=8, **GEO)
    one = _replay(recs, engine=engine)
    sh = _replay(recs, engine=engine, shards=shards)
    assert _equal(sh.state, one.state)
    assert len(sh.engine) == shards
    assert [p["tenants"] for p in sh.report["per_shard"]] == \
        [S // shards] * shards
    assert sum(p["session_steps"] for p in sh.report["per_shard"]) == \
        one.report["session_steps"]
    for op in {r["op"] for r in recs}:
        assert sh.metrics.counter("replay_ops_total", op=op).value == \
            one.metrics.counter("replay_ops_total", op=op).value
    assert sh.metrics.counter("engine_ticks_total", engine=engine).value \
        == one.metrics.counter("engine_ticks_total", engine=engine).value


@pytest.mark.parametrize("engine", ["classification", "regression"])
def test_replay_equals_direct_observe_many(engine):
    recs = loadgen.generate("zipf", ops=120, engine=engine, seed=8,
                            predict_every=10, **GEO)
    res = _replay(recs, engine=engine, chunk=6)
    cls = RegressionServingEngine if engine == "regression" else \
        ServingEngine
    eng = cls(n_sessions=S, capacity=CAP, dim=DIM, k=K, window=CAP // 2,
              device="cpu")
    state = eng.init_state()
    for r in recs:
        if r["op"] != "observe":
            continue
        rng = np.random.default_rng((3, r["seq"], 0))
        x = rng.standard_normal((S, DIM)).astype(np.float32)
        y = (rng.standard_normal(S).astype(np.float32)
             if engine == "regression"
             else (rng.random(S) < 0.5).astype(np.int32))
        tau = rng.random(S).astype(np.float32)
        act = np.zeros(S, bool)
        act[r["active"]] = True
        state, _ = eng.observe_many(state, x[None], y[None], tau[None],
                                    act[None])
    assert _equal(res.state, state)


def test_replay_guard_rejects_value_faults_without_nan():
    plan = _plan(FaultPlan, steps=160, rate=0.1)
    recs = loadgen.generate("steady", ops=160, seed=2, faults=plan, **GEO)
    faults = [r["fault"]["kind"] for r in recs
              if r.get("fault", {}).get("kind") in VALUE_FAULTS]
    assert faults
    res = _replay(recs, guard=True, chunk=4)
    rej = res.report["guard"]["rejected"]
    assert rej["nonfinite_feature"] == sum(
        f in ("nan_feature", "inf_feature") for f in faults)
    assert rej["label_out_of_range"] == faults.count("label_out_of_range")
    assert rej["tau_out_of_range"] == faults.count("tau_out_of_range")
    for leaf in res.state.leaves():
        if leaf.is_floating_point():
            assert not bool(leaf.isnan().any())


def test_replay_report_and_metrics(bursty, bursty_replayed):
    rep = bursty_replayed.report
    n_obs = sum(r["op"] == "observe" for r in bursty)
    assert rep["ticks"] == n_obs and rep["session_steps"] == n_obs * S
    assert set(rep["per_op"]) == {"observe", "predict"}
    for d in rep["per_op"].values():
        assert 0 < d["p50_s"] <= d["p99_s"]
        assert d["sojourn_p99_s"] > 0
    assert math.isnan(rep["slo_violation_frac"])
    names = {m["name"]
             for m in bursty_replayed.metrics.to_dict()["metrics"]}
    assert {"replay_sojourn_s", "replay_queue_depth", "replay_steps_per_s",
            "replay_slo_violation_frac", "replay_ops_total"} <= names
    tight = _replay(bursty, slo_s=1e-12).report
    assert tight["slo_violation_frac"] == 1.0


def test_replay_skips_unreplayable_ops(bursty):
    recs = list(bursty) + [{
        "schema": 3, "seq": bursty[-1]["seq"] + 1,
        "t": bursty[-1]["t"] + 1.0, "op": "snapshot_save", "wall_s": 0.0}]
    rep = _replay(recs).report
    assert rep["ops_skipped"] == 1 and rep["ops_replayed"] == len(bursty)


def test_replay_refusals(bursty):
    with pytest.raises(ValueError, match="replayable"):
        _replay([])
    for speedup in (0.0, -1.0):
        with pytest.raises(ValueError, match="speedup"):
            _replay(bursty, speedup=speedup)
    for shards in (0, S + 1):
        with pytest.raises(ValueError, match="shards"):
            _replay(bursty, shards=shards)


# -------------------------------------------------------------- cost model


def test_calibrate_records_validate_and_suggest_the_same_chunk(tmp_path):
    recs = calibrate_engine("classification", tenants=2, capacity=16, dim=4,
                            k=3, chunks=(1, 4, 16), reps=2, seed=0,
                            device="cpu")
    path = str(tmp_path / "cal.jsonl")
    write_trace(path, recs)
    assert validate_trace_file(path) == jvalidate(path) == recs
    assert sum(r.get("compile", False) for r in recs) == 3
    planted = [dict(r, wall_s=2e-4 + 3e-5 * r["ticks"]) for r in recs]
    t, j = CostModel.fit(planted), JCostModel.fit(planted)
    assert t.entries == j.entries
    for f in (0.02, 0.05, 0.2):
        assert t.suggest_chunk(cap_bucket=16, overhead_frac=f) == \
            j.suggest_chunk(cap_bucket=16, overhead_frac=f)
    assert CostModel.fit(recs).entries  # the measured walls fit too


# --------------------------------------------------------- the launcher


def test_serve_replay_classification_from_loadgen(tmp_path, capsys):
    from repro_torch.launch import serve

    mpath, tpath = str(tmp_path / "m.json"), str(tmp_path / "t.jsonl")
    rc = serve.main(["--replay", "loadgen:bursty", "--steps", "48",
                     "--sessions", "3", "--dim", "4", "--k", "3",
                     "--capacity", "16", "--window", "16", "--slo-ms",
                     "1000", "--auto-tune", "--shed-depth", "4",
                     "--faults", "1", "--fault-rate", "0.1", "--guard",
                     "--shards", "3", "--metrics-out", mpath,
                     "--trace-out", tpath, "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "replay loadgen:bursty -> classification engine" in out
    assert "auto-tune: observe_many chunk <-" in out
    assert "SLO 1000ms" in out and "shed(depth 4)" in out
    assert "guard: rejected" in out and "shard 2:" in out
    names = {m["name"] for m in json.load(open(mpath))["metrics"]}
    assert {"replay_steps_per_s", "serve_shards"} <= names
    assert validate_trace_file(tpath)


def test_serve_replay_regression_from_file(tmp_path, capsys):
    from repro_torch.launch import serve

    recs = loadgen.generate("zipf", ops=24, tenants=3, capacity=16,
                            engine="regression", seed=6)
    tpath = str(tmp_path / "t.jsonl")
    write_trace(tpath, recs)
    cm = str(tmp_path / "cm.json")
    rc = serve.main(["--replay", tpath, "--regression", "--dim", "4",
                     "--k", "3", "--speedup", "500", "--cost-model-out", cm,
                     "--device", "cpu"])
    assert rc == 0
    assert "-> regression engine" in capsys.readouterr().out
    rc = serve.main(["--replay", tpath, "--regression", "--dim", "4",
                     "--k", "3", "--cost-model", cm, "--auto-tune",
                     "--device", "cpu"])
    assert rc == 0
    assert "cost model <-" in capsys.readouterr().out


def test_serve_replay_refusals(tmp_path):
    from repro_torch.launch import serve

    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    with pytest.raises(SystemExit, match="no records"):
        serve.main(["--replay", str(empty), "--device", "cpu"])
    with pytest.raises(SystemExit, match="exclusive"):
        serve.main(["--replay", "loadgen:steady", "--measure", "knn",
                    "--device", "cpu"])
    for shards in ("0", "4"):
        with pytest.raises(SystemExit, match="shards"):
            serve.main(["--replay", "loadgen:steady", "--sessions", "3",
                        "--steps", "8", "--shards", shards, "--device",
                        "cpu"])
    with pytest.raises(SystemExit, match="exceeds the 1 visible device"):
        serve.main(["--sessions", "4", "--steps", "4", "--shards", "2",
                    "--device", "cpu"])
