"""The port's multi-device code (``repro_torch.core.distributed`` and its
callers) on the CPU, with explicit ``devices=[cpu] * N``: logical shards
on one device, the port's counterpart of XLA's forced host device count.

Inside the port every sharded result is bitwise its one-device twin:
engine states leaf by leaf, per-tick p-values, reads, drained tick stats
(``shard_vals`` one row a shard), grow mode, padded tenant counts, the
fleet, snapshots restored onto another shard count, and the row-sharded
k-NN / KDE CP across row and query shard counts. Against the JAX
package: the sharded engines against the JAX engines at ``shards=1``
(the tolerances of ``test_torch_serving.py`` / ``test_torch_regression
.py``), and the row-sharded CP and ``ConformalLmClassifier.fit(mesh=)``
against the JAX functions at mesh (4, 2), run in a child process with 8
forced XLA host devices, within 1e-6 (the reference's own tolerance in
``tests/test_sharding_rules.py``: at n = 101 that is equal counts).
"""
import ast
import json
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.regression import RegressionServingEngine as JaxReg  # noqa: E402
from repro.serving import ServingEngine as JaxCls  # noqa: E402
from repro_torch.analysis import audit  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.core import lm_conformal as lmc  # noqa: E402
from repro_torch.core.measures import kde as kde_m  # noqa: E402
from repro_torch.core.measures import knn as knn_m  # noqa: E402
from repro_torch.data.synthetic import make_classification  # noqa: E402
from repro_torch.launch import mesh as mesh_m  # noqa: E402
from repro_torch.regression import RegressionServingEngine  # noqa: E402
from repro_torch.robustness import TickGuard  # noqa: E402
from repro_torch.serving import (AsyncShardedSaver, Fleet,  # noqa: E402
                                 ServingEngine, SessionStore, convert)
from repro_torch.telemetry import MetricsRegistry  # noqa: E402
from test_torch_regression import _assert_pvalues_close, _ill_rows  # noqa: E402,E501

CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
S, T, D, CAP, K, W = 12, 20, 4, 32, 3, 8


def cpus(n):
    return [CPU] * n


def _traffic(seed=0, S=S, T=T):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(T, S, D)).astype(np.float32)
    ys_cls = rng.integers(0, 3, size=(T, S)).astype(np.int32)
    ys_reg = rng.normal(size=(T, S)).astype(np.float32)
    taus = rng.uniform(size=(T, S)).astype(np.float32)
    act = rng.uniform(size=(T, S)) < 0.7
    return xs, ys_cls, ys_reg, taus, act


def bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits (floats as int32, so NaNs and signed zeros
    compare)."""
    return t.view(torch.int32) if t.is_floating_point() else t


def same(a, b) -> bool:
    return a.shape == b.shape and torch.equal(bits(a), bits(b))


def same_state(a, b) -> bool:
    la = dist.gather_tenants(a, CPU).leaves()
    lb = dist.gather_tenants(b, CPU).leaves()
    return len(la) == len(lb) and all(same(x, y) for x, y in zip(la, lb))


def _engine(family, shards, **kw):
    args = dict(n_sessions=S, capacity=CAP, dim=D, k=K, window=W,
                shards=shards, devices=cpus(shards))
    args.update(kw)
    if family == "classification":
        return ServingEngine(n_labels=3, **args)
    return RegressionServingEngine(**args)


def _run(family, eng, state, traffic, T=T):
    xs, ys_cls, ys_reg, taus, act = traffic
    ys = ys_cls if family == "classification" else ys_reg
    return eng.observe_many(state, xs[:T], ys[:T], taus[:T],
                            active=act[:T])


def _reads(family, eng, state, xq):
    if family == "classification":
        return [eng.predict(state, xq)]
    return [eng.intervals(state, xq, epsilon=0.1),
            eng.pvalues(state, xq, torch.linspace(-1, 1, 5))]


# ---------------------------------------------------------------------------
# tenant helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,shards,want", [(8, 4, 8), (9, 4, 12), (1, 8, 8),
                                           (0, 4, 0), (12, 1, 12)])
def test_pad_tenant_count(n, shards, want):
    assert dist.pad_tenant_count(n, shards) == want


def test_tenant_mesh_checks():
    with pytest.raises(ValueError, match="shards must be >= 1"):
        dist.pad_tenant_count(8, 0)
    with pytest.raises(ValueError, match="shards must be >= 1"):
        dist.tenant_mesh(0, cpus(1))
    with pytest.raises(ValueError, match="exceeds the 2 visible.*devices="):
        dist.tenant_mesh(3, cpus(2))
    mesh = dist.tenant_mesh(2, cpus(4))
    assert mesh.axis_names == (dist.TENANT_AXIS,)
    assert mesh.shape == {dist.TENANT_AXIS: 2} and mesh.flat() == cpus(2)
    assert dist.visible_devices("cpu") == [CPU]
    # no explicit devices: N shards need N visible devices of the kind
    with pytest.raises(ValueError, match="exceeds the 1 visible device"):
        ServingEngine(n_sessions=4, capacity=8, dim=2, k=2, shards=2,
                      device="cpu")
    with pytest.raises(ValueError, match="not divisible by shards 4"):
        _engine("classification", 4, n_sessions=10)
    eng = ServingEngine(n_sessions=4, capacity=8, dim=2, k=2,
                        devices=cpus(1))
    assert eng.mesh is None and eng.device == CPU


def test_meshes():
    m = dist.make_mesh((4, 2), ("data", "model"), cpus(8))
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    with pytest.raises(ValueError, match="needs 8 devices"):
        dist.make_mesh((4, 2), ("data", "model"), cpus(7))
    host = mesh_m.make_host_mesh(4, 2, device="cpu")
    assert host.shape == {"data": 1, "model": 1}
    assert mesh_m.make_mesh((2,), ("x",), cpus(2)).flat() == cpus(2)


def test_put_and_gather_tenants_round_trip():
    tree = {"a": torch.arange(10.0), "b": torch.arange(30).view(10, 3)}
    sh = dist.put_tenant_sharded(tree, dist.tenant_mesh(4, cpus(4)))
    assert sh.cuts == [0, 2, 5, 7, 10] and sh.n_lanes == 10
    assert [p["b"].shape[0] for p in sh.parts] == [2, 3, 2, 3]
    back = dist.gather_tenants(sh)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    # each part owns its storage
    sh.parts[0]["a"][0] = -1.0
    assert tree["a"][0] == 0.0
    part, lane = sh.locate(6)
    assert part is sh.parts[2] and lane == 1
    with pytest.raises(IndexError):
        sh.locate(10)
    eng = _engine("classification", 1)
    state = _run("classification", eng, eng.init_state(), _traffic())[0]
    sh = dist.put_tenant_sharded(state, dist.tenant_mesh(3, cpus(3)))
    assert type(sh.parts[0]) is type(state)
    assert same_state(sh, state) and sh.capacity == state.capacity


def test_module_keeps_its_own_big():
    src = (ROOT / "src/repro_torch/core/distributed.py").read_text()
    assigned = [n.targets[0].id for n in ast.parse(src).body
                if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name)]
    assert "BIG" in assigned and dist.BIG == 1e30


# ---------------------------------------------------------------------------
# the engines: sharded == one device, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["classification", "regression"])
def test_sharded_engine_bitwise_one_device(family):
    traffic = _traffic()
    ref = None
    for shards in (1, 2, 4):
        eng = _engine(family, shards, instrument=True,
                      metrics=MetricsRegistry())
        st, p = _run(family, eng, eng.init_state(), traffic)
        st, p1 = eng.observe(st, traffic[0][0], (traffic[1] if family ==
                             "classification" else traffic[2])[0],
                             traffic[3][0])
        reads = _reads(family, eng, st, traffic[0][0])
        stats = eng.telemetry.ticks.drain()
        got = (st, p, p1, reads, stats)
        if shards > 1:
            assert isinstance(st, dist.TenantSharded)
            assert [pt.knn.X.shape[0] if family == "classification"
                    else pt.X.shape[0] for pt in st.parts] == \
                [S // shards] * shards
            assert len(eng.telemetry.ticks.shard_vals) == shards
            assert eng.meta()["shards"] == shards
        if ref is None:
            ref = got
            assert stats["evictions"] > 0
            continue
        assert same_state(st, ref[0]), f"state @{shards}"
        assert same(p, ref[1]) and same(p1, ref[2]), f"p-values @{shards}"
        assert all(same(a, b) for a, b in zip(reads, ref[3]))
        assert stats == ref[4], (shards, stats, ref[4])
        rows = eng.telemetry.ticks.shard_vals
        assert sum(r["ticks"] for r in rows) == stats["ticks"]
        assert max(r["occupancy_max"] for r in rows) == \
            stats["occupancy_max"]


@pytest.mark.parametrize("family", ["classification", "regression"])
def test_sharded_grow_mode_grows_every_shard(family):
    traffic = _traffic(1)
    ref = None
    for shards in (1, 4):
        eng = _engine(family, shards, capacity=8, window=None)
        st, p = _run(family, eng, eng.init_state(), traffic)  # 8 -> 32
        assert eng.capacity == 32
        assert all(pt.capacity == 32 for pt in dist.parts_of(st))
        reads = _reads(family, eng, st, traffic[0][1])
        if ref is None:
            ref = (st, p, reads)
            continue
        assert same_state(st, ref[0]) and same(p, ref[1])
        assert all(same(a, b) for a, b in zip(reads, ref[2]))
        meta = eng.meta()
        assert meta["shards"] == 4
        cls = type(eng)
        assert cls.from_meta(meta, devices=cpus(4)).shards == 4
        # this host has one CPU device: the reference's fallback
        assert cls.from_meta(meta, device="cpu").shards == 1
        assert cls.from_meta(meta, devices=cpus(3)).shards == 1


def test_uneven_tenants_padded_with_inactive_lanes():
    xs, ys, _, taus, act = _traffic(2)
    live, shards = 10, 4
    padded = dist.pad_tenant_count(live, shards)
    ref = _engine("classification", 1, n_sessions=live)
    rst, rp = ref.observe_many(ref.init_state(), xs[:, :live],
                               ys[:, :live], taus[:, :live],
                               active=act[:, :live])
    pad_act = np.concatenate([act[:, :live],
                              np.zeros((T, padded - live), bool)], 1)
    eng = _engine("classification", shards, n_sessions=padded)
    st, p = eng.observe_many(eng.init_state(), xs[:, :padded],
                             ys[:, :padded], taus[:, :padded],
                             active=pad_act)
    whole = dist.gather_tenants(st)
    init = dist.gather_tenants(eng.init_state())
    for a, b, c in zip(whole.leaves(), rst.leaves(), init.leaves()):
        assert same(a[:live], b), "live lanes diverged under padding"
        assert same(a[live:], c[live:]), "padding lanes changed"
    assert same(p[:, :live], rp)


def test_donate_false_leaves_the_sharded_state_alone():
    eng = _engine("classification", 2, donate=False)
    st0 = eng.init_state()
    before = [t.clone() for t in st0.leaves()]
    st1, _ = _run("classification", eng, st0, _traffic())
    assert all(torch.equal(a, b) for a, b in zip(before, st0.leaves()))
    assert not same_state(st0, st1)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_classification_engine_against_jax(shards):
    """Tolerances of ``test_torch_serving.py``: p-values 1e-6, float
    leaves 1e-5, integer leaves exactly."""
    xs, ys, _, taus, act = _traffic(3)
    kw = dict(n_sessions=S, capacity=CAP, dim=D, k=K, window=W,
              n_labels=3)
    jeng = JaxCls(**kw, donate=False)
    jst, jp = jeng.observe_many(jeng.init_state(), jnp.asarray(xs),
                                jnp.asarray(ys), jnp.asarray(taus),
                                jnp.asarray(act))
    eng = _engine("classification", shards)
    st, p = eng.observe_many(eng.init_state(), xs, ys, taus, active=act)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-6)
    got = convert.session_to_numpy(dist.gather_tenants(st))
    for i, (g, w) in enumerate(zip(got, jax.tree_util.tree_leaves(jst))):
        w = np.asarray(w)
        if i in (1, 3, 5, 6, 7):
            np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        eng.predict(st, xs[0]).numpy(),
        np.asarray(jeng.predict(jst, jnp.asarray(xs[0]))), atol=1e-6)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_regression_engine_against_jax(shards):
    """Tolerances of ``test_torch_regression.py``: p-values 1e-5 (a
    difference would be a near-tie), intervals 1e-4 with the NaN pattern
    exact on rows without an ill-conditioned cell."""
    xs, _, ys, taus, act = _traffic(4)
    kw = dict(n_sessions=S, capacity=CAP, dim=D, k=K, window=W)
    jeng = JaxReg(**kw, donate=False)
    jst, jp = jeng.observe_many(jeng.init_state(), jnp.asarray(xs),
                                jnp.asarray(ys), jnp.asarray(taus),
                                jnp.asarray(act))
    eng = _engine("regression", shards)
    st, p = eng.observe_many(eng.init_state(), xs, ys, taus, active=act)
    _assert_pvalues_close(p.numpy(), np.asarray(jp), CAP)
    whole = dist.gather_tenants(st)
    xq = np.random.default_rng(5).standard_normal((S, 6, D)).astype(
        np.float32)
    got = eng.intervals(st, xq, epsilon=0.1234567).numpy()
    want = np.asarray(jeng.intervals(jst, jnp.asarray(xq),
                                     epsilon=0.1234567))
    ok = _ill_rows(whole, xq, K) == 0
    assert ok.mean() >= 0.4
    np.testing.assert_array_equal(np.isnan(got[ok]), np.isnan(want[ok]))
    np.testing.assert_allclose(got[ok], want[ok], atol=1e-4, rtol=1e-4)
    tq = np.linspace(-2.0, 2.0, 7).astype(np.float32) + 0.0137
    _assert_pvalues_close(
        eng.pvalues(st, xq, tq).numpy(),
        np.asarray(jeng.pvalues(jst, jnp.asarray(xq), jnp.asarray(tq))),
        CAP)


def test_guard_over_a_sharded_engine_equals_one_device():
    xs, ys, _, taus, act = _traffic(6)
    xs, act = xs.copy(), act.copy()
    xs[5, 7, 0], act[5, 7] = np.nan, True  # rejected at admission
    out = []
    for shards in (1, 3):
        eng = _engine("classification", shards)
        guard = TickGuard(eng)
        st, p = guard.observe_many(eng.init_state(), xs, ys, taus, act)
        st = guard.finalize(st)
        out.append((st, p, guard.drain()))
    assert same_state(out[0][0], out[1][0]) and same(out[0][1], out[1][1])
    assert out[0][2] == out[1][2] and sum(out[0][2]["rejected"].values())


# ---------------------------------------------------------------------------
# fleet and snapshots
# ---------------------------------------------------------------------------


def test_sharded_fleet_equals_one_device():
    """The case of the JAX ``tests/test_fleet.py`` sharded fleet: three
    tenants grow through the buckets 8 -> 32 on pools of 8 lanes."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(20, 3, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=(20, 3)).astype(np.int32)
    tau = rng.uniform(size=(20, 3)).astype(np.float32)
    tids = ("a", "b", "c")
    ref = None
    for shards in (1, 4):
        fleet = Fleet(dim=3, k=3, n_labels=3, cap_min=8, cap_max=32,
                      pool_sessions=6, shards=shards, devices=cpus(shards))
        assert fleet.pool_sessions == (6 if shards == 1 else 8)
        for t in tids:
            fleet.admit(t)
        ps = [[fleet.observe({t: (x[s, i], y[s, i], tau[s, i])
                              for i, t in enumerate(tids)})[t]
               for t in tids] for s in range(20)]
        ps = torch.stack([torch.stack(r) for r in ps])
        pv = torch.stack([fleet.predict(t, x[0]) for t in tids])
        fleet.retire("b")
        if ref is None:
            ref = (ps, pv)
            continue
        assert same(ps, ref[0]) and same(pv, ref[1])
        assert fleet.stats()["pools"][-1]["capacity"] == 32


@pytest.mark.parametrize("family", ["classification", "regression"])
def test_sharded_snapshot_restores_onto_any_shard_count(family, tmp_path):
    eng = _engine(family, 4)
    st, _ = _run(family, eng, eng.init_state(), _traffic(8))
    store = SessionStore(str(tmp_path / "a"))
    store.save(3, st, meta=eng.meta(), blocking=True)
    saver = AsyncShardedSaver(SessionStore(str(tmp_path / "b")), 4)
    saver.save(4, st, meta=eng.meta())
    saver.close()
    for root, step in (("a", 3), ("b", 4)):
        s = SessionStore(str(tmp_path / root))
        for devices, shards in ((cpus(4), 4), (cpus(2), 1), (None, 1)):
            eng2, st2, got = s.restore_engine(device="cpu",
                                              devices=devices)
            assert got == step and eng2.shards == shards
            assert same_state(st2, st)
        # onto 2 shards: the restored state re-sharded by a 2-shard engine
        eng2 = _engine(family, 2)
        st2 = eng2.shard_state(s.restore(device="cpu")[0])
        assert len(st2.parts) == 2 and same_state(st2, st)
        xq = _traffic(9)[0][0]
        assert all(same(a, b) for a, b in zip(_reads(family, eng2, st2, xq),
                                              _reads(family, eng, st, xq)))


def test_launcher_serves_sharded_sessions(monkeypatch, capsys, tmp_path):
    """``launch.serve --shards 2`` on a CPU made to show two devices: the
    engines run two shards and the snapshot round trip (the sharded
    saver) is bit-exact."""
    from repro_torch.core import engine_utils
    from repro_torch.launch import serve

    two = lambda device=None: cpus(2)  # noqa: E731
    monkeypatch.setattr(serve, "visible_devices", two)
    monkeypatch.setattr(engine_utils.dist, "visible_devices", two)
    for extra in ([], ["--regression"]):
        rc = serve.main(["--sessions", "4", "--steps", "24", "--window",
                         "16", "--capacity", "16", "--dim", "4", "--k",
                         "3", "--device", "cpu", "--shards", "2",
                         "--snapshot-dir", str(tmp_path / str(len(extra)))]
                        + extra)
        out = capsys.readouterr().out
        assert rc == 0 and "shards=2) on cpu, cpu" in out
        assert "restore bit-exact" in out


# ---------------------------------------------------------------------------
# row-sharded CP
# ---------------------------------------------------------------------------

_N, _P, _KNN = 101, 6, 5


def _cp_data():
    X, y = make_classification(n_samples=_N, n_features=_P, seed=0)
    X, y = X.astype(np.float32), y.astype(np.int32)
    return X, y, X[:6] + 0.05


_JAX_CP = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.data.synthetic import make_classification
    from repro.core.measures import kde as kde_m, knn as knn_m
    from repro.core import distributed as dist
    from repro.core.lm_conformal import ConformalLmClassifier
    assert jax.device_count() == 8
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    X, y = make_classification(n_samples=101, n_features=6, seed=0)
    X = X.astype(np.float32); y = y.astype(np.int32)
    Xte = X[:6] + 0.05
    cfg = dist.CpShardingConfig(row_axes=("data",), query_axis="model")
    q = jax.device_put(jnp.asarray(Xte), NamedSharding(mesh, P("model")))
    out = {}
    st = knn_m.fit(jnp.asarray(X), jnp.asarray(y), k=5)
    for simplified in (False, True):
        fn = dist.make_knn_pvalues_fn(mesh, k=5, simplified=simplified,
                                      n_labels=2, cfg=cfg)
        out[f"knn{int(simplified)}"] = np.asarray(
            fn(dist.shard_knn_state(st, mesh, cfg), q)).tolist()
    ks = kde_m.fit(jnp.asarray(X), jnp.asarray(y), h=1.0, n_labels=2)
    pad = lambda a, f: dist.pad_rows(np.asarray(a), 104, f)
    fn = dist.make_kde_pvalues_fn(mesh, h=1.0, p_dim=6, n_labels=2, cfg=cfg)
    out["kde"] = np.asarray(fn(pad(ks.X, 0.0), pad(ks.y, -1),
                               pad(ks.prelim, 0.0), q)).tolist()
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((96, 12)).astype(np.float32)
    lab = rng.integers(0, 3, 96).astype(np.int32)
    emb += lab[:, None] * 0.5
    qe = rng.standard_normal((8, 12)).astype(np.float32)
    clf = ConformalLmClassifier(n_labels=3, k=5).fit(emb, lab, mesh=mesh)
    out["lm"] = np.asarray(clf.pvalues(qe)).tolist()
    print("JSON" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_cp():
    r = subprocess.run([sys.executable, "-c", _JAX_CP], capture_output=True,
                       text=True, timeout=600, cwd=ROOT,
                       env={**__import__("os").environ,
                            "PYTHONPATH": str(ROOT / "src")})
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JSON")]
    assert line, r.stdout + r.stderr
    return {k: np.asarray(v, np.float32)
            for k, v in json.loads(line[0][4:]).items()}


def _mesh(R, Q):
    return dist.make_mesh((R, Q), ("data", "model"), cpus(R * Q))


@pytest.mark.parametrize("simplified", [False, True])
def test_row_sharded_knn_against_jax(jax_cp, simplified):
    X, y, Xte = _cp_data()
    st = knn_m.fit(torch.from_numpy(X), torch.from_numpy(y), k=_KNN)
    mesh = _mesh(4, 2)
    fn = dist.make_knn_pvalues_fn(mesh, k=_KNN, simplified=simplified,
                                  n_labels=2)
    got = fn(dist.shard_knn_state(st, mesh), torch.from_numpy(Xte))
    want = jax_cp[f"knn{int(simplified)}"]
    assert got.shape == want.shape == (6, 2)
    assert np.abs(got.numpy() - want).max() < 1e-6


def test_row_sharded_kde_against_jax(jax_cp):
    X, y, Xte = _cp_data()
    st = kde_m.fit(torch.from_numpy(X), torch.from_numpy(y), h=1.0,
                   n_labels=2)
    fn = dist.make_kde_pvalues_fn(_mesh(4, 2), h=1.0, p_dim=_P, n_labels=2)
    got = fn(st.X, st.y, st.prelim, torch.from_numpy(Xte))
    assert np.abs(got.numpy() - jax_cp["kde"]).max() < 1e-6


def _cp_outputs(kind, data):
    X, y, Xte = data
    Xt, yt, qt = (torch.from_numpy(a) for a in (X, y, Xte))
    out = {}
    if kind == "kde":
        st = kde_m.fit(Xt, yt, h=0.7, n_labels=3)
    else:
        st = knn_m.fit(Xt, yt, k=_KNN)
    for R in (1, 2, 4, 8):
        for Q in (1, 2):
            mesh = _mesh(R, Q)
            if kind == "kde":
                fn = dist.make_kde_pvalues_fn(mesh, h=0.7, p_dim=X.shape[1],
                                              n_labels=3)
                out[R, Q] = fn(st.X, st.y, st.prelim, qt)
            else:
                fn = dist.make_knn_pvalues_fn(
                    mesh, k=_KNN, simplified=kind == "simplified",
                    n_labels=3)
                out[R, Q] = fn(dist.shard_knn_state(st, mesh), qt)
    return out


@pytest.mark.parametrize("kind", ["knn", "simplified", "kde"])
def test_row_sharded_cp_bitwise_across_shard_counts(kind):
    """Rows 701 (not a multiple of any row-shard count, and more than two
    of the KDE's 256-row blocks), 3 labels, 9 queries (odd: query shards
    of 4 and 5); ``dist.BLOCK_ELEMS`` small, so the queries go in several
    blocks."""
    X, y = make_classification(n_samples=701, n_features=_P, n_classes=3,
                               seed=2)
    X, y = X.astype(np.float32), y.astype(np.int32)
    data = (X, y, X[:9] + 0.03)
    out = _cp_outputs(kind, data)
    ref = out[1, 1]
    assert ref.shape == (9, 3) and bool(torch.isfinite(ref).all())
    for key, got in out.items():
        assert same(got, ref), key
    kept = dist.BLOCK_ELEMS
    try:
        dist.BLOCK_ELEMS = 3 * 701 * 2
        assert same(_cp_outputs(kind, data)[4, 2], ref)
    finally:
        dist.BLOCK_ELEMS = kept
    if kind != "kde":  # the single-device path: another distance rounding
        st = knn_m.fit(torch.from_numpy(X), torch.from_numpy(y), k=_KNN)
        single = knn_m.pvalues_optimized(
            st, torch.from_numpy(data[2]), k=_KNN,
            simplified=kind == "simplified", n_labels=3)
        assert float((single - ref).abs().max()) <= 2.0 / 702


def test_lm_classifier_fit_on_a_mesh(jax_cp):
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((96, 12)).astype(np.float32)
    lab = rng.integers(0, 3, 96).astype(np.int32)
    emb += lab[:, None] * 0.5
    qe = rng.standard_normal((8, 12)).astype(np.float32)
    clf = lmc.ConformalLmClassifier(n_labels=3, k=5).fit(
        emb, lab, mesh=_mesh(4, 2))
    got = clf.pvalues(qe)
    assert clf._sharded_fn is not None
    assert np.abs(got.numpy() - jax_cp["lm"]).max() < 1e-6
    two = lmc.ConformalLmClassifier(n_labels=3, k=5).fit(
        emb, lab, mesh=_mesh(2, 1))
    assert same(two.pvalues(qe), got)
    one = lmc.ConformalLmClassifier(n_labels=3, k=5).fit(
        emb, lab, mesh=_mesh(1, 1))
    assert one._sharded_fn is None  # one device: the plain path
    plain = lmc.ConformalLmClassifier(n_labels=3, k=5, device="cpu").fit(
        emb, lab)
    assert same(one.pvalues(qe), plain.pvalues(qe))


# ---------------------------------------------------------------------------
# the audit's shard dimension
# ---------------------------------------------------------------------------


def test_audit_matrix_has_eight_shard_targets():
    ts = audit.engine_matrix()
    sharded = [t for t in ts if t.shards == 8]
    assert len(sharded) == 8 and all(t.n_sessions // t.shards >= 2
                                     for t in sharded)
    assert not any(t.shards > 1 for t in audit.engine_matrix(quick=True))
    assert audit.shard_devices(CPU, 8) == cpus(8)
    assert sharded[0].describe()["shards"] == 8


@pytest.mark.parametrize("family", ["classification", "regression"])
def test_planted_cross_shard_write_fails_collective_freedom(family):
    t = next(t for t in audit.engine_matrix()
             if (t.family, t.shards, t.mode, t.layout)
             == (family, 8, "sliding", "ring"))

    def plant(eng):
        step, seen = eng._step, []

        def faulty(state, *args, **kw):
            state, p = step(state, *args, **kw)
            if seen and seen[-1] is not state:
                state.D[0, 0, 0] += seen[-1].D[0, 0, 0] * 0.0
            seen.append(state)
            return state, p

        eng._step = faulty

    bad = audit.check_collectives(t, audit.Artifact(t, "cpu", plant))
    assert bad["status"] == "fail"
    assert {v["kind"] for v in bad["violations"]} == {"cross-shard"}
    clean = audit.check_collectives(t, audit.Artifact(t, "cpu"))
    assert clean["status"] == "pass", clean["violations"]
