"""The port's figures runner (``repro_torch.launch.figures``) end to end on
the CPU at small n, its budget rule (the paper's timeouts), and the
standard paths it times in row blocks: the blocks give the bits of one
pass, and the standard paths still equal the optimized ones and the JAX
package's.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.measures import kde as jkde  # noqa: E402
from repro.core.measures import knn as jknn  # noqa: E402
from repro_torch.core.measures import kde, knn  # noqa: E402
from repro_torch.launch import figures  # noqa: E402

PATHS = {  # measure -> the read paths a full run reports
    "knn": {"standard", "optimized", "icp"},
    "simplified_knn": {"standard", "optimized", "icp"},
    "kde": {"standard", "optimized", "icp"},
    "lssvm": {"standard", "optimized", "icp"},
    "bootstrap": {"standard", "optimized"},
    "regression": {"standard", "optimized", "icp"},
}


def _run(ns=(16, 32), **kw):
    lines = []
    rows, checks, notes = figures.run_grid(ns, m=4, m_std=2, device="cpu",
                                           emit=lines.append, **kw)
    return rows, checks, notes, lines


def test_figures_runs_every_measure_end_to_end():
    rows, checks, notes, lines = _run(
        table2_n=40, budget=figures.Budget(point_s=600.0, fit_s=600.0))
    for line in lines:
        if line.startswith("{"):
            assert set(json.loads(line)) >= {"figure", "measure", "path",
                                             "n", "ms", "cut", "points"}
    ran = {(r["measure"], r["path"], r["n"]) for r in rows
           if r["figure"] in ("fig2", "fig4") and r["cut"] is None}
    for measure, paths in PATHS.items():
        for path in paths:
            assert (measure, path, 32) in ran, (measure, path)
    for r in rows:
        assert (r["ms"] is None) == (r["cut"] is not None)
    # k 15: at n = 16 the ICP proper training set (8 points) is too small
    small = [r for r in rows if r["n"] == 16 and r["path"] == "icp"
             and r["measure"] == "knn"]
    assert small[0]["cut"].startswith("n=16: the proper training set")
    assert set(checks[32]) == {"knn", "simplified_knn", "kde", "lssvm",
                               "regression"}
    assert len(notes) == 2 and {r["figure"] for r in rows} == {
        "fig2", "fig3", "fig4", "table2"}
    table = figures.table(rows)
    assert any(line.startswith("fig4    regression") for line in table)
    lines = figures.report(rows, checks, notes)
    assert sum(line.startswith("[check] n=32: optimized == standard: knn "
                               "p-values equal") for line in lines) == 1
    assert len([x for x in lines if x.startswith("[cut] fig2 knn icp:")]) == 1


def test_budget_cuts_the_next_n_and_every_larger_one():
    b = figures.Budget(point_s=2.0, fit_s=60.0)
    std, opt = ("fig2", "knn", "standard"), ("fig2", "knn", "optimized")
    fit = ("fig3", "kde", "fit")
    assert b.check(std, 10) is None
    b.record(std, 10, 0.5)  # n^2: 2 s exactly at n = 20 still runs
    assert b.check(std, 20) is None
    b.record(std, 20, 0.6)  # 2.4 s predicted at n = 40
    assert "2.4 s a point predicted from 0.6 s at n=20" in b.check(std, 40)
    assert b.check(std, 80) == b.check(std, 40)
    b.record(opt, 10, 0.5)  # n^1: 2 s at n = 40
    assert b.check(opt, 40) is None and b.check(opt, 41) is not None
    b.record(fit, 100, 10.0)  # n^2: 40 s at 200, 90 s at 300
    assert b.check(fit, 200) is None and "> 60 s" in b.check(fit, 300)


def test_figures_applies_the_cut_rule():
    """A budget no path can meet: every path that ran at the first n is
    cut at the next, with the prediction that cut it; a path too small to
    run at the first n (k-NN ICP) runs at the next."""
    rows, _, _, _ = _run(budget=figures.Budget(point_s=1e-9, fit_s=1e-9))
    ran16 = {(r["figure"], r["measure"], r["path"]) for r in rows
             if r["n"] == 16 and r["cut"] is None}
    at32 = {(r["figure"], r["measure"], r["path"]): r for r in rows
            if r["n"] == 32}
    assert ("fig2", "kde", "standard") in ran16
    for key in ran16:
        assert "predicted from" in at32[key]["cut"], key
    assert at32[("fig2", "knn", "icp")]["cut"] is None


def test_figures_main_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        figures.main(["--grid", "smoke"])


def _cls(seed, n, labels=3, p=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, p)).astype(np.float32),
            rng.integers(0, labels, n).astype(np.int32))


@pytest.mark.parametrize("simplified", [False, True])
def test_knn_standard_in_row_blocks_equals_one_pass_and_jax(simplified,
                                                            monkeypatch):
    X, y = map(torch.from_numpy, _cls(1, 40))
    Xt = torch.from_numpy(_cls(2, 5)[0])
    kw = dict(k=4, simplified=simplified, n_labels=3)
    whole = knn.pvalues_standard(X, y, Xt, **kw)
    a_whole = knn.scores_standard(X, y, Xt[0], 1, k=4,
                                  simplified=simplified)
    for rows in (1, 6):
        monkeypatch.setattr(knn, "BLOCK_ELEMS", rows * 41)
        assert torch.equal(knn.pvalues_standard(X, y, Xt, **kw), whole)
        got = knn.scores_standard(X, y, Xt[0], 1, k=4, simplified=simplified)
        assert all(torch.equal(a, b) for a, b in zip(got, a_whole))
    monkeypatch.undo()
    assert torch.equal(whole, knn.pvalues_optimized(knn.fit(X, y, k=4), Xt,
                                                    **kw))
    want = jknn.pvalues_standard(jnp.asarray(X.numpy()),
                                 jnp.asarray(y.numpy()),
                                 jnp.asarray(Xt.numpy()), **kw)
    np.testing.assert_allclose(whole.numpy(), np.asarray(want), atol=1e-6)


def test_kde_standard_counts_match_jax():
    """The standard path's same-label counts come from the label counts
    (no (n + 1)^2 comparison); scores and p-values as before."""
    X, y = _cls(3, 30)
    Xt = _cls(4, 4)[0]
    for y_hat in (0, 2):
        got = kde.scores_standard(torch.from_numpy(X), torch.from_numpy(y),
                                  torch.from_numpy(Xt[0]), y_hat, h=0.8,
                                  p_dim=6)
        want = jkde.scores_standard(jnp.asarray(X), jnp.asarray(y),
                                    jnp.asarray(Xt[0]), y_hat, h=0.8,
                                    p_dim=6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    st = kde.fit(torch.from_numpy(X), torch.from_numpy(y), h=0.8,
                 n_labels=3)
    kw = dict(h=0.8, p_dim=6, n_labels=3)
    assert torch.equal(
        kde.pvalues_standard(torch.from_numpy(X), torch.from_numpy(y),
                             torch.from_numpy(Xt), **kw),
        kde.pvalues_optimized(st, torch.from_numpy(Xt), **kw))


def _reg_intervals(seed=7, n=60, m=12, k=7):
    from repro_torch.core import regression as reg
    from repro_torch.data.synthetic import make_regression

    X, y = (torch.from_numpy(a) for a in make_regression(n + m, 6, seed=seed))
    st = reg.fit(X[:n], y[:n], k=k)
    kw = dict(k=k, epsilon=0.1)
    return (st, X[n:], reg.intervals_standard(X[:n], y[:n], X[n:], **kw),
            reg.intervals_optimized(st, X[n:], **kw))


def test_interval_check_fails_on_a_moved_endpoint():
    """The figures' optimized == standard interval check is a gate: equal
    intervals pass with every row checked in full, an endpoint moved by
    1e-3 on a row fails, and so does a run where fewer than a quarter of
    the rows can be checked in full (every cell flagged at rel = 1e3)."""
    st, Xq, iv_std, iv_opt = _reg_intervals()
    ok, note = figures.check_intervals(st, Xq, iv_std, iv_opt, k=7)
    assert ok and note.startswith("intervals equal on 12 of 12 rows, 12 "
                                  "checked in full"), note
    for row, side in ((0, 0), (5, 1)):
        moved = iv_opt.clone()
        moved[row, side] += 1e-3
        assert not figures.check_intervals(st, Xq, iv_std, moved, k=7)[0]
    nan = iv_opt.clone()
    nan[3] = float("nan")
    assert not figures.check_intervals(st, Xq, iv_std, nan, k=7)[0]
    ok, note = figures.check_intervals(st, Xq, iv_std, iv_opt, k=7, rel=1e3)
    assert not ok and "0 checked in full" in note


def test_interval_check_exempts_only_a_flagged_cells_window():
    """An endpoint may differ only inside the window around -a where an
    ill-conditioned cell's set lies: moved to the window's edge on a row
    that holds such a cell (made so with a larger rel) it passes, moved
    just past the edge it fails."""
    st, Xq, iv_std, iv_opt = _reg_intervals()
    from repro_torch.core import regression as reg

    a = reg.ab_optimized(st, Xq, k=7)[2].double()
    rel = 0.5
    reach = rel * (1.0 + a.abs()) * 7 / 6
    for past, want in ((0.0, True), (1e-2, False)):
        moved = iv_opt.clone()
        moved[2, 1] = float(-a[2] + reach[2] + past)
        ok, note = figures.check_intervals(st, Xq, iv_std, moved, k=7,
                                           rel=rel)
        assert ok == want, (past, note)
