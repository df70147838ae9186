"""The invariant audit restated for torch (``repro_torch.analysis``).

* every lint rule fires on a planted snippet and stays silent under the
  ``# audit: allow`` pragma; keyed draws, syncs outside the tick roots and
  handlers outside the durability layers stay silent;
* ``lint_tree(src/repro_torch)`` is clean;
* the CPU audit exits 0 with ``ok: true`` in the JAX report's layout;
* planted faults fail their checker: a tick that reallocates ``D`` fails
  ``in-place``, one that materialises an ``(S, cap, cap)`` temporary
  fails ``dense-budget``, a data-dependent op count fails
  ``steady-state``.
"""
import json
import os
import pathlib
import textwrap

import pytest
import torch

from repro_torch.analysis import audit, lint

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PRAGMA = "  # audit: allow"

#: rule -> (path under a repro_torch tree, snippet with one marked line)
PLANTED = {
    "np-random": ("unkeyed-randomness", "core/x.py", """
        import numpy as np

        def f():
            return np.random.normal(size=3)  # MARK
        """),
    "stdlib-random": ("unkeyed-randomness", "core/x.py", """
        import random

        def f():
            return random.random()  # MARK
        """),
    "torch-rand": ("unkeyed-randomness", "core/x.py", """
        import torch

        def f():
            return torch.randn(3)  # MARK
        """),
    "torch-randint": ("unkeyed-randomness", "core/x.py", """
        import torch as th

        def f():
            return th.randint(0, 5, (3,))  # MARK
        """),
    "inplace-normal": ("unkeyed-randomness", "core/x.py", """
        def f(t):
            return t.normal_()  # MARK
        """),
    "item": ("host-sync-in-tick", "serving/session.py", """
        def _sliding_step(sess, x):
            return sess.n.max().item()  # MARK
        """),
    "cpu-in-helper": ("host-sync-in-tick", "regression/session.py", """
        def _helper(t):
            return t.cpu()  # MARK

        def _sliding_step_compact(st, x):
            return _helper(st.n)
        """),
    "tolist": ("host-sync-in-tick", "core/online.py", """
        def _observe_impl(state):
            return state.n.tolist()  # MARK
        """),
    "numpy": ("host-sync-in-tick", "regression/stream.py", """
        def evict_oldest(st, *, k):
            return st.n.numpy()  # MARK
        """),
    "asarray": ("host-sync-in-tick", "kernels/ops.py", """
        import numpy as np

        def stream_update(X):
            return np.asarray(X)  # MARK
        """),
    "synchronize": ("host-sync-in-tick", "models/lm.py", """
        import torch

        def decode_step(params, cfg, tokens, cache, index):
            torch.cuda.synchronize()  # MARK
        """),
    "clock": ("host-sync-in-tick", "kernels/ref.py", """
        import time

        def drop_backfill(L):
            return time.perf_counter()  # MARK
        """),
    "as-tensor-scalar": ("host-sync-in-tick", "kernels/ops.py", """
        import torch

        def _scalars(v, S, device):
            return torch.as_tensor(v, device=device).expand(S)  # MARK

        def stream_tick(X, n):
            return _scalars(n, X.shape[0], X.device)
        """),
    "tensor-from-host": ("host-sync-in-tick", "serving/session.py", """
        import torch as th

        def _sliding_step(sess, w):
            return th.tensor([w], device=sess.n.device)  # MARK
        """),
    "tenant-loop": ("tenant-python-loop", "serving/engine.py", """
        def tick(self, state):
            for s in range(self.n_sessions):  # MARK
                state = step(state, s)
            return state
        """),
    "bare-except": ("swallowed-exception", "checkpoint/store.py", """
        def save(f):
            try:
                f()
            except:  # MARK
                raise
        """),
    "pass-handler": ("swallowed-exception", "robustness/guard.py", """
        def save(f):
            try:
                f()
            except OSError:  # MARK
                pass
        """),
}


def _lint_snippet(tmp_path, rel, src, pragma=False):
    src = textwrap.dedent(src)
    if pragma:
        src = src.replace("  # MARK", PRAGMA)
    path = tmp_path / "repro_torch" / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    mark = next(i for i, ln in enumerate(src.splitlines(), 1)
                if "# MARK" in ln or "# audit: allow" in ln)
    return lint.lint_paths([str(path)]), mark


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_lint_rule_fires_on_planted_snippet(tmp_path, name):
    rule, rel, src = PLANTED[name]
    vs, mark = _lint_snippet(tmp_path, rel, src)
    assert [(v.rule, v.line) for v in vs] == [(rule, mark)]
    assert rule in lint.RULE_NAMES


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_lint_rule_silent_under_pragma(tmp_path, name):
    _, rel, src = PLANTED[name]
    vs, _ = _lint_snippet(tmp_path, rel, src, pragma=True)
    assert vs == []


SILENT = {
    "keyed-draws": ("core/x.py", """
        import numpy as np
        import torch

        def f(g, seed):
            a = np.random.default_rng(seed).normal(size=3)
            b = torch.randn(3, generator=g)
            return a, b, torch.empty(3).uniform_(generator=g)
        """),
    "sync-outside-the-tick": ("serving/session.py", """
        def predict_pvalues(sess):
            return sess.n.max().item()

        def _sliding_step(sess):
            return sess.n + 1
        """),
    "filled-on-the-device": ("kernels/ops.py", """
        import torch

        def stream_tick(X, n):
            m = torch.full((), n, dtype=torch.int32, device=X.device)
            return m, torch.as_tensor(n)
        """),
    "engine-wrapper-times": ("serving/engine.py", """
        import time

        def observe(self, state):
            t0 = time.perf_counter()
            for t in range(4):
                state = step(state, t)
            return state, time.perf_counter() - t0
        """),
    "handler-outside-scope": ("telemetry/x.py", """
        def f(g):
            try:
                g()
            except OSError:
                pass
        """),
    "handler-that-records": ("serving/x.py", """
        def f(g, log):
            try:
                g()
            except OSError as e:
                log.append(e)
        """),
}


@pytest.mark.parametrize("name", sorted(SILENT))
def test_lint_silent_where_nothing_is_wrong(tmp_path, name):
    rel, src = SILENT[name]
    path = tmp_path / "repro_torch" / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    assert lint.lint_paths([str(path)]) == []


def test_lint_reports_a_parse_error(tmp_path):
    path = tmp_path / "bad.py"
    path.write_text("def f(:\n")
    (v,) = lint.lint_paths([str(path)])
    assert v.rule == "parse-error"


def test_port_sources_lint_clean():
    vs = lint.lint_tree(str(PORT))
    assert vs == [], [v.as_dict() for v in vs]


def test_tick_roots_exist_in_the_port():
    """Every declared root names a function of its module, so a rename
    cannot silently drop a tick from the rule."""
    import ast

    for rel, roots in lint.TICK_ROOTS.items():
        tree = ast.parse((PORT / rel).read_text())
        defined = {n.name for n in ast.walk(tree)
                   if isinstance(n, ast.FunctionDef)}
        assert set(roots) <= defined, rel


# ------------------------------------------------------------------ audit


@pytest.fixture(scope="module")
def cpu_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("audit") / "report.json"
    rc = audit.main(["--device", "cpu", "--out", str(out)])
    return rc, json.loads(out.read_text())


def test_cpu_audit_exits_zero_and_ok(cpu_report):
    rc, rep = cpu_report
    assert rc == 0 and rep["ok"] is True
    assert {"checks", "summary", "ok", "targets", "torch", "device"} <= \
        set(rep)
    assert rep["device"] == "cpu" and rep["summary"]["fail"] == 0
    assert rep["matrix"] == {"engine_targets": 16, "measure_targets": 6,
                             "quick": False}


def test_cpu_audit_statuses(cpu_report):
    _, rep = cpu_report
    status = {(c["check"], c["target"]): c["status"] for c in rep["checks"]}
    assert status[("source-lint", "src")] == "pass"
    for t in rep["targets"]:
        name = t["name"]
        if t["kind"] == "measure":
            assert {status[(c, name)] for c in audit.CHECKERS} == \
                {"skipped"}
            continue
        ring = t["layout"] == "ring"
        assert status[("in-place", name)] == ("pass" if ring else "waived")
        assert status[("dense-budget", name)] == (
            "waived" if (t["layout"], t["mode"]) == ("compact", "sliding")
            else "pass")
        assert status[("steady-state", name)] == "pass"
        assert status[("host-sync", name)] == "skipped"
        assert status[("collective-freedom", name)] == (
            "pass" if t["shards"] > 1 else "skipped")


def test_quick_audit_matrix(tmp_path):
    out = tmp_path / "quick.json"
    assert audit.main(["--device", "cpu", "--quick", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] and rep["matrix"] == {"engine_targets": 6,
                                           "measure_targets": 3,
                                           "quick": True}
    assert not any(t["name"].endswith("grow-compact")
                   for t in rep["targets"])


def _target(family="classification", mode="sliding", layout="ring"):
    return next(t for t in audit.engine_matrix()
                if (t.family, t.mode, t.layout) == (family, mode, layout))


def _hooked(hook):
    """An engine hook wrapping each tick with ``hook(state)``."""
    def install(eng):
        step = eng._step

        def faulty(state, *args, **kw):
            state, p = step(state, *args, **kw)
            hook(state)
            return state, p

        eng._step = faulty
    return install


@pytest.mark.parametrize("family", ["classification", "regression"])
def test_planted_reallocation_of_D_fails_in_place(family):
    def realloc(state):
        state.D = state.D.clone()

    t = _target(family)
    res = audit.check_in_place(t, audit.Artifact(t, "cpu", _hooked(realloc)))
    assert res["status"] == "fail"
    assert res["violations"][0]["leaf"] == "D"
    clean = audit.check_in_place(t, audit.Artifact(t, "cpu"))
    assert clean["status"] == "pass"


@pytest.mark.parametrize("family", ["classification", "regression"])
def test_planted_dense_temporary_fails_dense_budget(family):
    def dense(state):
        state.D.add_(state.D * 0.0)  # an (S, cap, cap) temporary

    t = _target(family, mode="grow")
    res = audit.check_dense(t, audit.Artifact(t, "cpu", _hooked(dense)))
    assert res["status"] == "fail"
    assert res["violations"][0]["shape"] == [t.n_sessions, t.capacity,
                                             t.capacity]


@pytest.mark.parametrize("family", ["classification", "regression"])
def test_planted_data_dependent_ops_fail_steady_state(family):
    def extra(state):
        for _ in range(int(state.n.max()) % 3):
            torch.zeros(1)

    t = _target(family)
    res = audit.check_steady(t, audit.Artifact(t, "cpu", _hooked(extra)))
    assert res["status"] == "fail"
    assert res["violations"][0]["kind"] == "op-sequence"


def test_audit_is_bitwise_neutral():
    """The audit's recording changes nothing a tick computes."""
    t = _target()
    art = audit.Artifact(t, "cpu")
    a, b = art.build_engine(), art.build_engine()
    sa, sb = a.init_state(), b.init_state()
    with audit.OpRecorder(min_numel=1) as rec:
        sa = art.lifecycle(a, sa)
    sb = art.lifecycle(b, sb)
    assert rec.ops and rec.fresh
    assert all(torch.equal(x, y) for x, y in zip(sa.leaves(), sb.leaves()))


def test_serve_audit_flag(tmp_path, capsys):
    from repro_torch.launch import serve

    out = tmp_path / "a.json"
    rc = serve.main(["--audit", "--audit-out", str(out), "--device", "cpu"])
    assert rc == 0 and json.loads(out.read_text())["ok"]
    assert "audit:" in capsys.readouterr().out
    assert os.path.getsize(out) > 0
