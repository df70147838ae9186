"""The port's telemetry against the JAX package's.

* metrics and tracer: the behaviours of ``tests/test_telemetry.py``, run
  on both packages' modules;
* a port trace passes the JAX ``validate_trace_file`` and the other way;
* instrumented engines (both modes, ring and compact, grow and sliding)
  are bitwise the plain ones;
* the drained device tick counters equal the JAX instrumented engine's
  on the same gated traffic, and an offline per-tick simulation, exactly;
* the validity monitors equal JAX's on the same p-value streams;
* the launcher's sessions mode with the shell's flags writes a valid
  trace and metrics JSON.
"""
import importlib
import io
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.regression import RegressionServingEngine as JaxReg  # noqa: E402
from repro.serving import ServingEngine as JaxCls  # noqa: E402
from repro.telemetry import MetricsRegistry as JaxRegistry  # noqa: E402
from repro_torch.regression import RegressionServingEngine  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.telemetry import (EngineTelemetry,  # noqa: E402
                                   MetricsRegistry, Tracer)
from repro_torch.telemetry.device import (STAT_KEYS, combine,  # noqa: E402
                                         make_chunk_stats_fn)

PKGS = ["repro", "repro_torch"]


def _tele(pkg, mod):
    return importlib.import_module(f"{pkg}.telemetry.{mod}")


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("pkg", PKGS)
def test_counter_gauge_identity_and_labels(pkg):
    reg = _tele(pkg, "metrics").MetricsRegistry()
    reg.counter("ops_total", op="observe").inc()
    reg.counter("ops_total", op="observe").inc(2)
    reg.counter("ops_total", op="predict").inc()
    assert reg.counter("ops_total", op="observe").value == 3
    assert reg.counter("ops_total", op="predict").value == 1
    with pytest.raises(ValueError):
        reg.counter("ops_total", op="observe").inc(-1)
    reg.gauge("occ").set(7)
    reg.gauge("occ").set(5)
    assert reg.gauge("occ").value == 5


@pytest.mark.parametrize("pkg", PKGS)
def test_histogram_quantiles_overflow_and_bounds(pkg):
    Histogram = _tele(pkg, "metrics").Histogram
    h = Histogram("h", (), bounds=(1.0, 2.0, 4.0, 8.0))
    for v in (0.5, 1.5, 1.5, 3.0):
        h.observe(v)
    assert h.count == 4 and h.sum == pytest.approx(6.5)
    assert h.quantile(0.5) == pytest.approx(1.5)
    assert h.min <= h.quantile(0.0) <= h.quantile(1.0) <= h.max
    o = Histogram("o", (), bounds=(1.0,))
    o.observe(100.0)
    assert o.quantile(0.99) == pytest.approx(100.0)
    assert o.quantile_is_lower_bound(0.99)
    with pytest.raises(ValueError):
        Histogram("h", (), bounds=(2.0, 1.0))
    with pytest.raises(ValueError):
        Histogram("h", (), bounds=())
    e = Histogram("e", (), bounds=(1.0,))
    assert math.isnan(e.quantile(0.5))
    with pytest.raises(ValueError):
        e.quantile(1.5)


@pytest.mark.parametrize("pkg", PKGS)
def test_text_export_escaping_series_and_empty(pkg):
    reg = _tele(pkg, "metrics").MetricsRegistry()
    h = reg.histogram("lat_s", op="observe")
    assert "empty=1" in reg.to_text()
    h.observe(1.0)
    h.observe(3.0)
    reg.counter("c_total", path='a"b\\c\nd').inc()
    text = reg.to_text()
    assert "empty=1" not in text
    assert 'lat_s_count{op="observe"} 2' in text
    assert 'lat_s_sum{op="observe"} 4' in text
    assert r'path="a\"b\\c\nd"' in text


@pytest.mark.parametrize("pkg", PKGS)
def test_registry_dump_and_merge(pkg, tmp_path):
    m = _tele(pkg, "metrics")
    a, b = m.MetricsRegistry(), m.MetricsRegistry()
    a.counter("a_total", engine="classification").inc(4)
    b.counter("a_total", engine="classification").inc(3)
    a.gauge("g").set(5.0)
    b.gauge("g").set(2.0)
    a.histogram("c_s").observe(0.01)
    b.histogram("c_s").observe(0.02)
    a.merge(b, gauge_policy="sum")
    assert a.counter("a_total", engine="classification").value == 7
    assert a.gauge("g").value == 7.0 and a.histogram("c_s").count == 2
    path = str(tmp_path / "m.json")
    a.dump(path)
    by_name = {e["name"]: e for e in json.load(open(path))["metrics"]}
    assert by_name["a_total"]["labels"] == {"engine": "classification"}
    assert by_name["c_s"]["count"] == 2
    with pytest.raises(ValueError, match="mismatched bucket"):
        m.Histogram("h", (), bounds=(1.0,)).merge(
            m.Histogram("h", (), bounds=(2.0,)))


def test_both_registries_render_the_same_text():
    regs = [_tele(p, "metrics").MetricsRegistry() for p in PKGS]
    for r in regs:
        r.counter("ops_total", op="observe").inc(3)
        r.gauge("occ", engine="c").set(1.25)
        for v in (1e-4, 2e-3, 5.0):
            r.histogram("wall_s", op="observe").observe(v)
    assert regs[0].to_text() == regs[1].to_text()


# ----------------------------------------------------------------- tracer


@pytest.mark.parametrize("pkg", PKGS)
def test_trace_schema_roundtrip(pkg, tmp_path):
    tr_m = _tele(pkg, "tracer")
    path = str(tmp_path / "t.jsonl")
    tr = tr_m.Tracer(path, annotate=True)
    tr.record("observe", 0.001, tenants=4, ticks=1, capacity=100,
              engine="classification")
    with tr.op("observe_many", signature=(64, 256), tenants=8) as ctx:
        ctx.late["ticks"] = 64
    with tr.op("observe_many", signature=(64, 256)):
        pass
    tr.close()
    recs = tr_m.validate_trace_file(path)
    assert [r["op"] for r in recs] == ["observe", "observe_many",
                                      "observe_many"]
    assert recs[0]["capacity"] == 100 and recs[0]["cap_bucket"] == 128
    assert recs[1]["compile"] is True and recs[1]["ticks"] == 64
    assert recs[2]["compile"] is False
    assert [tr_m.capacity_bucket(c) for c in (1, 2, 3, 128, 129)] == \
        [1, 2, 4, 128, 256]
    with pytest.raises(ValueError):
        tr_m.validate_record({"schema": 1, "seq": True, "t": 0.0,
                              "op": "observe", "wall_s": 0.0})
    with pytest.raises(ValueError):
        tr_m.Tracer(io.StringIO()).record("nope", 0.0)


def _engine_trace(path, kind):
    """A trace recorded by an instrumented engine of package ``kind``."""
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((6, 3, 4)).astype(np.float32)
    ys = rng.integers(0, 2, (6, 3)).astype(np.int32)
    taus = rng.random((6, 3)).astype(np.float32)
    kw = dict(n_sessions=3, capacity=8, dim=4, k=2, window=6,
              instrument=True)
    if kind == "repro_torch":
        tr = Tracer(path)
        eng = ServingEngine(**kw, metrics=MetricsRegistry(), tracer=tr,
                            device="cpu")
        state, _ = eng.observe_many(eng.init_state(), xs, ys, taus)
        state, _ = eng.observe(state, xs[0], ys[0], taus[0])
        eng.predict(state, xs[0])
    else:
        jt = _tele("repro", "tracer")
        tr = jt.Tracer(path)
        eng = JaxCls(**kw, metrics=JaxRegistry(), tracer=tr)
        state, _ = eng.observe_many(eng.init_state(), jnp.asarray(xs),
                                    jnp.asarray(ys), jnp.asarray(taus))
        eng.predict(state, jnp.asarray(xs[0]))
    tr.close()


@pytest.mark.parametrize("writer,reader", [("repro_torch", "repro"),
                                           ("repro", "repro_torch")])
def test_traces_cross_validate(tmp_path, writer, reader):
    path = str(tmp_path / "t.jsonl")
    _engine_trace(path, writer)
    recs = _tele(reader, "tracer").validate_trace_file(path)
    assert {r["op"] for r in recs} >= {"observe_many", "predict"}
    assert all(r["engine"] == "classification" for r in recs)


# ------------------------------------------- instrumented == plain, bitwise


def _traffic(mode, S, T, dim, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, S, dim)).astype(np.float32)
    ys = (rng.integers(0, 2, (T, S)).astype(np.int32)
          if mode == "classification"
          else rng.standard_normal((T, S)).astype(np.float32))
    taus = rng.random((T, S)).astype(np.float32)
    active = rng.random((T, S)) < 0.8
    return xs, ys, taus, active


@pytest.mark.parametrize("window,layout,sync", [
    (None, "ring", False), (10, "ring", False), (10, "compact", False),
    (10, "ring", True)])
@pytest.mark.parametrize("mode", ["classification", "regression"])
def test_instrumented_engine_is_bitwise_the_plain_one(mode, window, layout,
                                                      sync):
    S, T, dim = 3, 26, 4
    xs, ys, taus, active = _traffic(mode, S, T, dim, seed=1)
    cls = ServingEngine if mode == "classification" else RegressionServingEngine
    kw = dict(n_sessions=S, capacity=16 if window else 8, dim=dim, k=3,
              window=window, layout=layout, device="cpu")
    plain = cls(**kw)
    trace = io.StringIO()
    inst = cls(**kw, instrument=True, metrics=MetricsRegistry(),
               tracer=Tracer(trace), sync_timing=sync)
    s1, p1 = plain.observe_many(plain.init_state(), xs, ys, taus, active)
    s2, p2 = inst.observe_many(inst.init_state(), xs, ys, taus, active)
    s1, q1 = plain.observe(s1, xs[0], ys[0], taus[0])
    s2, q2 = inst.observe(s2, xs[0], ys[0], taus[0])
    assert p1.numpy().tobytes() == p2.numpy().tobytes()
    assert q1.numpy().tobytes() == q2.numpy().tobytes()
    assert all(a.numpy().tobytes() == b.numpy().tobytes()
               for a, b in zip(s1.leaves(), s2.leaves()))
    Xq = xs[:2].transpose(1, 0, 2)
    if mode == "classification":
        r1, r2 = plain.predict(s1, Xq), inst.predict(s2, Xq)
    else:
        r1, r2 = plain.intervals(s1, Xq, 0.2), inst.intervals(s2, Xq, 0.2)
    assert r1.numpy().tobytes() == r2.numpy().tobytes()
    recs = [json.loads(ln) for ln in trace.getvalue().splitlines()]
    assert recs and all(("dispatch_s" in r) == sync for r in recs)
    if window is None:
        assert inst.capacity > 8  # grown under the timer
        ops = inst.telemetry.metrics.counter("engine_ops_total", op="grow",
                                             engine=mode).value
        assert ops >= 1


# ------------------------------------------------------ device tick stats


def _simulate_stats(n0, head0, wrap, windows, actives):
    """Per-tick simulation of the closed-form chunk stats."""
    n, head = n0.copy(), head0.copy()
    tot = {k: 0 for k in STAT_KEYS}
    for act in actives:
        ev = act & (n >= windows)
        tot["ticks"] += int(act.sum())
        tot["evictions"] += int(ev.sum())
        tot["ring_wraps"] += int((ev & (head == wrap - 1)).sum())
        tot["backfills"] += int(ev.sum())
        head = np.where(ev, (head + 1) % wrap, head)
        n = np.where(act, np.minimum(n + 1, windows), n)
        tot["occupancy_sum"] += int(n.sum())
        tot["occupancy_max"] = max(tot["occupancy_max"], int(n.max()))
    return tot


@pytest.mark.parametrize("flush_every", [2, 64])
@pytest.mark.parametrize("window", [6, None])
@pytest.mark.parametrize("mode", ["classification", "regression"])
def test_drained_tick_counters_equal_jax_and_a_simulation(mode, window,
                                                          flush_every):
    """Chunks of 7, 9 and 13 ticks; their stats computed by ``flush``
    after every second chunk or once at ``drain``, and one chunk at a
    time by ``make_chunk_stats_fn``."""
    S, dim, cap = 4, 4, 16 if window else 4
    treg, jreg = MetricsRegistry(), JaxRegistry()
    kw = dict(n_sessions=S, capacity=cap, dim=dim, k=3, window=window,
              instrument=True)
    if mode == "classification":
        teng = ServingEngine(**kw, metrics=treg, device="cpu")
        jeng = JaxCls(**kw, metrics=jreg)
    else:
        teng = RegressionServingEngine(**kw, metrics=treg, device="cpu")
        jeng = JaxReg(**kw, metrics=jreg)
    teng.telemetry.ticks.flush_every = flush_every
    stats_fn = make_chunk_stats_fn(lambda s: s.n, lambda s: s.head,
                                   lambda s: s.wrap)
    ts, js = teng.init_state(), jeng.init_state()
    rng = np.random.default_rng(0)
    total = {k: 0 for k in STAT_KEYS}
    one_by_one = None
    for chunk in (7, 9, 13):
        xs, ys, taus, _ = _traffic(mode, S, chunk, dim, seed=chunk)
        active = rng.random((chunk, S)) < 0.8
        pre = [t.numpy().copy() for t in (ts.n, ts.head, ts.wrap)]
        pre_state = ts.clone()
        ts, _ = teng.observe_many(ts, xs, ys, taus, active)
        # grow mode provisions the chunk first: its window is the
        # capacity in force during the chunk, plus one
        w = window if window else ts.capacity + 1
        ref = _simulate_stats(*pre, np.full(S, w), active)
        vec = stats_fn(pre_state, w, torch.from_numpy(active))
        one_by_one = vec if one_by_one is None else combine(one_by_one, vec)
        js, _ = jeng.observe_many(js, jnp.asarray(xs), jnp.asarray(ys),
                                  jnp.asarray(taus), jnp.asarray(active))
        for k in STAT_KEYS:
            total[k] = (max(total[k], ref[k]) if k == "occupancy_max"
                        else total[k] + ref[k])
    got, want = teng.telemetry.drain(), jeng.telemetry.drain()
    assert got == want == total == dict(zip(STAT_KEYS, one_by_one.tolist()))
    assert got["ring_wraps"] > 0 if window else got["evictions"] == 0
    for name in ("engine_ticks_total", "engine_evictions_total",
                 "engine_ring_wraps_total", "engine_occupancy_sum_total"):
        assert treg.counter(name, engine=mode).value == \
            jreg.counter(name, engine=mode).value
    assert treg.gauge("engine_occupancy_max", engine=mode).value == \
        jreg.gauge("engine_occupancy_max", engine=mode).value
    assert teng.telemetry.drain() == {k: 0 for k in STAT_KEYS}


def test_engine_telemetry_without_accessors_is_timing_only():
    tele = EngineTelemetry(engine="registry", metrics=MetricsRegistry(),
                           sync=True)
    assert tele.ticks is None
    with tele.timed("fit", signature="knn", tenants=1) as tm:
        tm.sync(torch.zeros(2))
    assert "dispatch_s" in tm.late
    assert tele.drain() == {}
    assert tele.metrics.counter("engine_ops_total", op="fit",
                                engine="registry").value == 1


# ------------------------------------------------------ validity monitors


def _pstream(seed=2, S=5, T=70):
    rng = np.random.default_rng(seed)
    p = rng.random((T, S))
    p[rng.random((T, S)) < 0.15] = np.nan  # inactive lane-ticks
    p[T // 2:, 1] *= 0.05  # one tenant drifts
    return p


@pytest.mark.parametrize("window", [16, 256])
def test_validity_monitors_equal_jax(window):
    p = _pstream()
    S = p.shape[1]
    out = {}
    for pkg in PKGS:
        v = _tele(pkg, "validity")
        cov = v.CoverageMonitor(0.1, S, window=window)
        uni = v.UniformityMonitor(S, window=window)
        drift = v.DriftMonitor(S, threshold=2.0)
        for row in p:
            cov.update(row)
            uni.update(row)
            drift.update(row)
        uni.update(p[:5])  # the (T, S) block form
        reg = _tele(pkg, "metrics").MetricsRegistry()
        for m in (cov, uni, drift):
            m.export(reg, engine="classification")
        out[pkg] = (cov.coverage(), cov.counts(), uni.ks(), drift.log_m(),
                    drift.max_log_m, drift.flagged(), reg.to_text())
    for a, b in zip(out["repro"], out["repro_torch"]):
        if isinstance(a, str):
            assert a == b
        else:
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert out["repro_torch"][5][1]  # the drifting tenant is flagged


# ---------------------------------------------------- the launcher, on CPU


@pytest.mark.parametrize("regression", [False, True])
def test_launcher_shell_flags_write_valid_trace_and_metrics(
        tmp_path, capsys, regression):
    from repro.telemetry import validate_trace_file as jax_validate
    from repro_torch.launch import serve
    from repro_torch.telemetry import validate_trace_file

    trace, mpath = str(tmp_path / "t.jsonl"), str(tmp_path / "m.json")
    argv = ["--sessions", "6", "--steps", "40", "--window", "16",
            "--capacity", "16", "--dim", "3", "--k", "3", "--queries", "4",
            "--device", "cpu", "--guard", "--snapshot-dir",
            str(tmp_path / "snap"), "--faults", "0", "--fault-rate", "0.1",
            "--metrics-out", mpath, "--trace-out", trace]
    if regression:
        argv.append("--regression")
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "restore bit-exact" in out and "chaos:" in out
    kind = "regression" if regression else "classification"
    recs = validate_trace_file(trace)
    assert jax_validate(trace) == recs
    ops = {r["op"] for r in recs}
    assert {"observe_many", "snapshot_save", "snapshot_restore"} <= ops
    by = {(e["name"], tuple(sorted(e["labels"].items()))): e
          for e in json.load(open(mpath))["metrics"]}
    assert by[("serve_session_steps_per_s", (("mode", kind),))]["value"] > 0
    assert by[("engine_evictions_total", (("engine", kind),))]["value"] > 0
    rejected = sum(e["value"] for (n, _), e in by.items()
                   if n == "guard_rejected_inputs_total")
    assert rejected > 0
    assert by[("snapshot_retries_total", ())]["value"] == 1


def test_launcher_refuses_shards_and_guarded_registry():
    from repro_torch.launch import serve

    base = ["--sessions", "4", "--steps", "8", "--device", "cpu"]
    with pytest.raises(SystemExit, match="not divisible by --shards 3"):
        serve.main(base + ["--shards", "3"])
    with pytest.raises(SystemExit, match="exceeds the 1 visible device"):
        serve.main(base + ["--shards", "2"])
    with pytest.raises(SystemExit, match="--shards must be >= 1"):
        serve.main(base + ["--shards", "0"])
    with pytest.raises(SystemExit, match="not --measure"):
        serve.main(base + ["--measure", "knn", "--guard"])
