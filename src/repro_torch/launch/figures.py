"""The paper's Figures 2-4 and Table 2 on the port, with bootstrap's
standard path against its optimized one.

    python -m repro_torch.launch.figures [--grid paper|smoke] \\
        [--device cuda] [--out rows.jsonl]

The port's runner for ``benchmarks/fig2_predict_time.py`` (ms a test point
of standard full CP, the paper's optimized full CP and ICP),
``fig3_train_time.py`` (fit ms), ``fig4_regression.py`` (k-NN regression:
Papadopoulos et al. 2011's standard path, the optimized path and ICP, k 7,
eps 0.1), ``table2_highdim.py`` (784 features, 10 labels: the repo's
synthetic stand-in for MNIST) and ``bootstrap_bench.py`` (standard against
optimized bootstrap). Measures: knn, simplified_knn, kde, lssvm (linear
kernel), bootstrap (no ICP in the reference) and regression.

``--grid paper`` is the paper's grid ``numpy.logspace(1, 5, 13)`` (10 ...
100,000) at App. E's settings (``configs/paper.py``: k 15, h 1, rho 1, B
10, depth 10, 30 features, t/n 0.5), 100 test points; ``--grid smoke`` is
n = 100, 1,000, 10,000 with 10 test points. The standard paths time
``M_STD`` points. Data come from ``data/synthetic.py`` with one seed (the
paper averages 5).

The paper's timeouts become a budget: a path stops growing n once its last
n's time, extrapolated by the path's complexity (``n^e``), would pass
``POINT_S`` seconds a test point, or ``FIT_S`` for a fit; an optimized or
ICP read whose fit was cut is cut with it, and a k-NN path whose set is
smaller than k does not run. Every cut is printed. Where the standard and
the optimized paths both run, their outputs on the standard's points are
compared: classification p-values exactly (LS-SVM outside near-ties, as
``chip_smoke.py`` phase 6 does), regression intervals under the rule of
``tests/test_torch_regression.py::test_intervals_optimized_equal_standard``
(equal within 1e-4, except an endpoint an ill-conditioned cell can
reach: ``check_intervals``); a mismatch fails the run. Bootstrap's two
paths draw different samples, so only their times are compared.

Output: one JSON object a row (figure, measure, path, n, ms, cut, points)
as it is measured, then a table; on the card, its name and power limit.
Times are on the host clock, synchronised, after a one-point warm-up of
each read at each n (fits: the first n only).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch._device import resolve
from repro_torch.configs.paper import CONFIG
from repro_torch.core import icp as icp_m
from repro_torch.core import pvalues as pv
from repro_torch.core import regression as reg
from repro_torch.core.measures import bootstrap as boot_m
from repro_torch.core.measures import kde as kde_m
from repro_torch.core.measures import knn as knn_m
from repro_torch.core.measures import lssvm as lssvm_m
from repro_torch.data.synthetic import make_classification, make_regression

GRIDS = {"paper": tuple(int(n) for n in CONFIG.paper_n_grid()),
         "smoke": (100, 1000, 10000)}
M_TEST = {"paper": CONFIG.n_test, "smoke": 10}
TABLE2_N = {"paper": 60_000, "smoke": 1_000}  # App. G: 60k training points
M_STD = 10  # test points the standard paths time
INF = float("inf")
POINT_S, FIT_S = 2.0, 60.0  # the budget: s a test point, s a fit
K_REG, EPS_REG = 7, 0.1  # benchmarks/fig4_regression.py
L = 2
# complexity exponent in n of each path's time (a read's per point)
EXPONENT = {"standard": 2, "optimized": 1, "icp": 1, "fit": 2,
            "icp_fit": 2}
EXPONENT_OF = {("lssvm", "fit"): 1, ("lssvm", "icp_fit"): 1,
               ("bootstrap", "fit"): 1, ("regression", "icp"): 2}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev: torch.device):
    """``(result, seconds)`` on the host clock, synchronised."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


class Budget:
    """The paper's timeouts as a budget per path: after each run, the next
    n of the path runs only if the last time, scaled by ``(n /
    n_last)^e``, stays within the limit."""

    def __init__(self, point_s: float = POINT_S, fit_s: float = FIT_S):
        self.point_s, self.fit_s = point_s, fit_s
        self.last: dict = {}
        self.cut: dict = {}

    def check(self, key, n: int):
        """``None`` if ``key = (figure, measure, path)`` may run at ``n``,
        else the reason it is cut (it stays cut for every larger n)."""
        if key in self.cut:
            return self.cut[key]
        if key not in self.last:
            return None
        n0, s0 = self.last[key]
        path = key[2]
        e = EXPONENT_OF.get((key[1], path), EXPONENT[path])
        want = s0 * (n / n0) ** e
        limit = self.fit_s if "fit" in path else self.point_s
        if want > limit:
            unit = "a fit" if "fit" in path else "a point"
            self.cut[key] = (f"n={n}: {want:.3g} s {unit} predicted from "
                             f"{s0:.3g} s at n={n0} (n^{e}) > {limit:g} s")
            return self.cut[key]
        return None

    def record(self, key, n: int, seconds: float) -> None:
        self.last[key] = (n, seconds)


class Run:
    """Rows, budget and output of one run."""

    def __init__(self, dev, budget: Budget, emit, out=None):
        self.dev, self.budget, self.emit, self.out = dev, budget, emit, out
        self.rows: list[dict] = []
        self.warm: set = set()
        self.fits: dict = {}  # measure -> its fit at the current n

    def row(self, figure, measure, path, n, ms, cut=None, points=None):
        r = dict(figure=figure, measure=measure, path=path, n=n, ms=ms,
                 cut=cut, points=points)
        self.rows.append(r)
        line = json.dumps(r)
        self.emit(line)
        if self.out is not None:
            self.out.write(line + "\n")
            self.out.flush()

    def path(self, figure, measure, path, n, fn, points, *, needs=None,
             warm=None):
        """Run ``fn`` for the path ``(figure, measure, path)`` at ``n``
        unless the budget (or a cut of the path ``needs``) says no; a read
        (``points`` > 0) reports ms a point after ``warm()``, a fit its
        ms. Returns the result or ``None`` when cut."""
        key = (figure, measure, path)
        reason = self.budget.check(key, n)
        if reason is None and needs is not None and needs in self.budget.cut:
            reason = self.budget.cut[key] = f"n={n}: its fit is cut"
        if reason is not None:
            self.row(figure, measure, path, n, None, cut=reason,
                     points=points or None)
            return None
        if warm is not None:
            warm()
        elif key not in self.warm:
            fn()
        self.warm.add(key)
        out, s = timed(fn, self.dev)
        per = s / points if points else s
        self.budget.record(key, n, per)
        self.row(figure, measure, path, n, per * 1e3,
                 points=points or None)
        return out


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"figures: {what}")


def check_intervals(st, Xq, iv_std, iv_opt, *, k, rel=1e-3):
    """Optimized == standard intervals on the standard's points:
    ``(ok, note)``. The rule of ``tests/test_torch_regression.py::
    test_intervals_optimized_equal_standard``, exact about where a row may
    differ: NaN pattern exact and endpoints within 1e-4 (and 1e-5
    relative), except an endpoint that one of the paths puts inside the
    window of an ill-conditioned cell, and at least a quarter of the rows
    checked in full.

    A cell ``i`` is ill-conditioned when its discriminant's root ``r =
    a_i - b_i a`` is below ``rel (1 + |a|)``: there the set ``{t :
    |a_i + b_i t| >= |a + t|}`` is at most ``|r| / (1 - |b_i|) <= |r| k /
    (k - 1)`` from ``-a`` on either side (the whole line at k = 1), and
    rounding alone decides it. Such a cell changes the count only inside
    that window, so it can move a hull endpoint only to a point inside
    it."""
    a_v, b_v, a = (v.double() for v in reg.ab_optimized(st, Xq, k=k))
    scale = rel * (1.0 + a.abs())
    ill = ((a_v - b_v * a[:, None]).abs() <= scale[:, None]).any(-1)
    reach = scale * k / (k - 1.0) if k > 1 else torch.full_like(a, INF)

    def inside(iv):  # (m, 2): endpoints in a flagged row's window
        t = iv.double()
        return ill[:, None] & ((t + a[:, None]).abs()
                               <= (reach + 1e-4)[:, None] + 1e-5 * t.abs())

    gap = (torch.nan_to_num(iv_opt) - torch.nan_to_num(iv_std)).abs()
    lim = 1e-4 + 1e-5 * torch.nan_to_num(iv_std).abs()
    differ = (iv_std.isnan() != iv_opt.isnan()) | (gap > lim)
    exempt = inside(iv_std) | inside(iv_opt)
    full = ~exempt.any(-1)
    m = full.numel()
    ok = not bool((differ & ~exempt).any()) and 4 * int(full.sum()) >= m
    return ok, (f"intervals equal on {m - int(differ.any(-1).sum())} of {m} "
                f"rows, {int(full.sum())} checked in full (>= a quarter), "
                f"{int(ill.sum())} holding an ill-conditioned cell")


def _equal_p(st, Xq, p_std, p_opt):
    return torch.equal(p_opt, p_std), "p-values equal"


def _lssvm_equal(st, Xq, p_std, p_opt):
    """LS-SVM optimized == standard p-values outside near-ties."""
    flagged = bad = 0
    for t in range(Xq.shape[0]):
        for c, y_hat in enumerate((-1.0, 1.0)):
            a_o, al_o = lssvm_m.scores_optimized(st, Xq[t], y_hat)
            tie = bool(((a_o - al_o).abs() <= 1e-4 * torch.maximum(
                a_o.abs(), al_o.abs()) + 1e-6).any())
            flagged += tie
            bad += not tie and float(p_std[t, c]) != float(p_opt[t, c])
    return bad == 0, f"p-values equal, {flagged} near-ties flagged"


@dataclass
class Measure:
    """One measure's paths at one n, each a callable: ``fit() -> state``,
    ``std(Xq)``, ``opt(state, Xq)``, ``icp_fit() -> icp state`` and
    ``icp(icp state, Xq)`` (no ``icp_fit``: ``icp`` fits too; no ``icp``:
    the reference has none), ``compare(state, Xq, std, opt) -> (ok,
    note)`` (``None``: the paths draw different samples). ``Xq`` is what
    the reads read, ``fit_of`` the measure whose fit ``opt`` reads, ``k``
    the points a k-NN path needs."""

    name: str
    Xq: torch.Tensor
    std: Callable
    opt: Callable
    fit: Callable | None = None
    icp: Callable | None = None
    icp_fit: Callable | None = None
    compare: Callable | None = None
    figure: str = "fig2"
    fit_of: str | None = None
    k: int = 0


def measure_rows(run: Run, n, ms: Measure, m_std):
    """Every path of ``ms`` at ``n`` the budget lets run; returns ``{name:
    note}`` for the optimized == standard comparison, if both ran (a
    mismatch fails the run)."""
    name, fig, Xq = ms.name, ms.figure, ms.Xq
    fit_of = ms.fit_of or name
    t = int(n * CONFIG.icp_train_frac)
    if n < ms.k:
        for f, p in [("fig3", "fit")] * (ms.fit is not None) + [
                (fig, "standard"), (fig, "optimized"), (fig, "icp")]:
            run.row(f, name, p, n, None,
                    cut=f"n={n}: the set holds {n} < k = {ms.k} points")
        return {}
    if ms.fit is not None:
        run.fits[fit_of] = run.path("fig3", name, "fit", n, ms.fit, 0)
    st = run.fits[fit_of]
    out_std = run.path(fig, name, "standard", n,
                       lambda: ms.std(Xq[:m_std]), m_std,
                       warm=lambda: ms.std(Xq[:1]))
    out_opt = run.path(fig, name, "optimized", n, lambda: ms.opt(st, Xq),
                       Xq.shape[0], needs=("fig3", fit_of, "fit"),
                       warm=lambda: ms.opt(st, Xq[:1]))
    if ms.icp is not None and t < ms.k:
        for f, p in [("fig3", "icp_fit")] * (ms.icp_fit is not None) + [
                (fig, "icp")]:
            run.row(f, name, p, n, None, cut=f"n={n}: the proper training "
                    f"set holds {t} < k = {ms.k} points")
    elif ms.icp is not None and ms.icp_fit is None:
        run.path(fig, name, "icp", n, lambda: ms.icp(None, Xq), Xq.shape[0])
    elif ms.icp is not None:
        ist = run.path("fig3", name, "icp_fit", n, ms.icp_fit, 0)
        run.path(fig, name, "icp", n, lambda: ms.icp(ist, Xq), Xq.shape[0],
                 needs=("fig3", name, "icp_fit"),
                 warm=lambda: ms.icp(ist, Xq[:1]))
    if ms.compare is None or out_std is None or out_opt is None:
        return {}
    ok, note = ms.compare(st, Xq[:m_std], out_std, out_opt[:m_std])
    _check(ok, f"{name} at n={n}: optimized != standard ({note})")
    return {name: note}


def _class_data(n, m, seed, dev):
    X, y = make_classification(n + m, CONFIG.n_features, seed=seed)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.int32, device=dev)
    return X[:n].contiguous(), y[:n].contiguous(), X[n:].contiguous()


def _knn(name, simplified, Xtr, ytr, Xte, t):
    k = CONFIG.knn_k
    kw = dict(k=k, simplified=simplified, n_labels=L)
    return Measure(
        name, Xte, fit_of="knn", k=k, compare=_equal_p,
        fit=None if simplified else (lambda: knn_m.fit(Xtr, ytr, k=k)),
        std=lambda Xq: knn_m.pvalues_standard(Xtr, ytr, Xq, **kw),
        opt=lambda st, Xq: knn_m.pvalues_optimized(st, Xq, **kw),
        icp_fit=lambda: icp_m.fit_knn(Xtr, ytr, k=k, simplified=simplified,
                                      t=t),
        icp=lambda ist, Xq: icp_m.pvalues_knn(ist, Xq, **kw))


def measures(n, m, seed, dev) -> list[Measure]:
    """Fig. 2-4's measures at ``n``, on ``m`` test points."""
    Xtr, ytr, Xte = _class_data(n, m, seed, dev)
    t = int(n * CONFIG.icp_train_frac)
    h, rho = CONFIG.kde_bandwidth, CONFIG.lssvm_rho
    kde_kw = dict(h=h, p_dim=CONFIG.n_features, n_labels=L)
    Y = 2.0 * ytr.to(torch.float32) - 1.0
    bkw = dict(n_labels=L, B=CONFIG.bootstrap_B, depth=CONFIG.tree_depth,
               seed=seed, device=dev)
    Xb, yb = Xtr.cpu().numpy(), ytr.cpu().numpy()
    Xr, yr = make_regression(n + m, CONFIG.n_features, seed=seed)
    Xr = torch.as_tensor(Xr, dtype=torch.float32, device=dev)
    yr = torch.as_tensor(yr, dtype=torch.float32, device=dev)
    Xrt, yrt = Xr[:n].contiguous(), yr[:n].contiguous()
    rkw = dict(k=K_REG, epsilon=EPS_REG)
    return [
        _knn("knn", False, Xtr, ytr, Xte, t),
        _knn("simplified_knn", True, Xtr, ytr, Xte, t),
        Measure("kde", Xte, compare=_equal_p,
                fit=lambda: kde_m.fit(Xtr, ytr, h=h, n_labels=L),
                std=lambda Xq: kde_m.pvalues_standard(Xtr, ytr, Xq,
                                                      **kde_kw),
                opt=lambda st, Xq: kde_m.pvalues_optimized(st, Xq, **kde_kw),
                icp_fit=lambda: icp_m.fit_kde(Xtr, ytr, t=t, **kde_kw),
                icp=lambda ist, Xq: icp_m.pvalues_kde(ist, Xq, **kde_kw)),
        Measure("lssvm", Xte, compare=_lssvm_equal,
                fit=lambda: lssvm_m.fit(Xtr, Y, rho),
                std=lambda Xq: lssvm_m.pvalues_standard(Xtr, Y, Xq, rho=rho),
                opt=lambda st, Xq: lssvm_m.pvalues_optimized(st, Xq),
                icp_fit=lambda: icp_m.fit_lssvm(Xtr, Y, rho, t=t),
                icp=lambda ist, Xq: icp_m.pvalues_lssvm(ist, Xq)),
        Measure("bootstrap", Xte,
                fit=lambda: boot_m.fit(Xb, yb, **bkw),
                std=lambda Xq: boot_m.pvalues_standard(
                    Xb, yb, Xq.cpu().numpy(), **bkw),
                opt=lambda st, Xq: boot_m.pvalues_optimized(
                    st, Xq.cpu().numpy())),
        Measure("regression", Xr[n:], figure="fig4", k=K_REG,
                fit=lambda: reg.fit(Xrt, yrt, k=K_REG),
                std=lambda Xq: reg.intervals_standard(Xrt, yrt, Xq, **rkw),
                opt=lambda st, Xq: reg.intervals_optimized(st, Xq, **rkw),
                icp=lambda _, Xq: reg.icp_intervals(Xrt, yrt, Xq, t=t,
                                                    **rkw),
                compare=lambda st, Xq, a, b: check_intervals(st, Xq, a, b,
                                                             k=K_REG)),
    ]


def table2(run: Run, n, m, seed):
    """Table 2 / App. G: 784 features, 10 labels (the synthetic stand-in
    of ``benchmarks/table2_highdim.py``); optimized fit and read against
    ICP, with fuzziness and coverage."""
    k, Lt, dev = CONFIG.knn_k, CONFIG.mnist_labels, run.dev
    X, y = make_classification(n + m, CONFIG.mnist_features,
                               n_informative=64, n_classes=Lt, seed=seed,
                               class_sep=2.0)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.int32, device=dev)
    Xtr, ytr, Xte, yte = X[:n].contiguous(), y[:n].contiguous(), X[n:], y[n:]
    t = int(n * CONFIG.icp_train_frac)
    notes = []
    st = run.path("table2", "knn", "fit", n, lambda: knn_m.fit(Xtr, ytr, k=k),
                  0)
    for simplified, name in ((True, "simplified_knn"), (False, "knn")):
        kw = dict(k=k, simplified=simplified, n_labels=Lt)
        p_cp = run.path("table2", name, "optimized", n,
                        lambda: knn_m.pvalues_optimized(st, Xte, **kw), m,
                        warm=lambda: knn_m.pvalues_optimized(st, Xte[:1],
                                                             **kw))
        ist = run.path("table2", name, "icp_fit", n,
                       lambda: icp_m.fit_knn(Xtr, ytr, k=k,
                                             simplified=simplified, t=t), 0)
        p_icp = run.path("table2", name, "icp", n,
                         lambda: icp_m.pvalues_knn(ist, Xte, **kw), m,
                         warm=lambda: icp_m.pvalues_knn(ist, Xte[:1], **kw))
        fz_cp = float(pv.fuzziness(p_cp).mean())
        fz_icp = float(pv.fuzziness(p_icp).mean())
        cov, _ = pv.coverage(p_cp, yte, 0.1)
        notes.append(f"{name}: fuzziness cp {fz_cp:.5f} icp {fz_icp:.5f} "
                     f"(cp better: {fz_cp <= fz_icp}), cp coverage at eps "
                     f"0.1 {float(cov):.3f}")
    return notes


def run_grid(ns, *, m, m_std=M_STD, device=None, seed=0, table2_n=None,
             budget=None, emit=print, out=None):
    """Every measure over ``ns``; returns ``(rows, checks, notes)``:
    ``checks`` the optimized == standard comparisons made, by n."""
    dev = resolve(device)
    run = Run(dev, budget or Budget(), emit, out)
    checks = {}
    for n in ns:
        checks[n] = {}
        for ms in measures(n, m, seed, dev):
            checks[n].update(measure_rows(run, n, ms, m_std))
        run.fits.clear()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    notes = table2(run, table2_n, m, seed) if table2_n else []
    return run.rows, checks, notes


def table(rows) -> list[str]:
    """One line per (figure, measure, n): ms a point of each read path,
    fit ms and the standard / optimized ratio; ``cut`` where a path did
    not run."""
    at = {}
    for r in rows:
        fig = "fig2" if r["figure"] == "fig3" else r["figure"]
        if r["measure"] == "regression" and fig == "fig2":
            fig = "fig4"
        at.setdefault((fig, r["measure"], r["n"]), {})[r["path"]] = r["ms"]
    fmt = lambda v: "cut" if v is None else f"{v:.4g}"  # noqa: E731
    lines = [f"{'figure':7s} {'measure':15s} {'n':>7s} {'standard':>10s} "
             f"{'optimized':>10s} {'icp':>10s} {'std/opt':>8s} "
             f"{'fit ms':>10s} {'icp fit':>10s}"]
    for (fig, measure, n), d in at.items():
        std, opt = d.get("standard"), d.get("optimized")
        ratio = (f"{std / opt:.1f}" if std is not None and opt else "-")
        lines.append(
            f"{fig:7s} {measure:15s} {n:7d} "
            + " ".join(f"{fmt(d[p]) if p in d else '-':>10s}"
                       for p in ("standard", "optimized", "icp"))
            + f" {ratio:>8s} "
            + " ".join(f"{fmt(d[p]) if p in d else '-':>10s}"
                       for p in ("fit", "icp_fit")))
    return lines


def report(rows, checks, notes) -> list[str]:
    """The run's summary: the table, each cut once, the optimized ==
    standard checks by n and Table 2's statistics."""
    lines = ["[table] " + line for line in table(rows)]
    cuts = {}
    for r in rows:
        if r["cut"] is not None:
            cuts.setdefault((r["figure"], r["measure"], r["path"]), r["cut"])
    lines += [f"[cut] {' '.join(key)}: {why}" for key, why in cuts.items()]
    lines += [f"[check] n={n}: optimized == standard: "
              + ("; ".join(f"{k} {v}" for k, v in done.items()) or "none")
              for n, done in checks.items()]
    return lines + ["[table2] " + note for note in notes]


def _smi_line() -> str | None:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", choices=sorted(GRIDS), default="paper")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the JSON rows to this file")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    ns, m = GRIDS[args.grid], M_TEST[args.grid]
    print(f"[figures] grid {args.grid} n={list(ns)}, {m} test points "
          f"({M_STD} on the standard paths), seed {args.seed} (1 of the "
          f"paper's {CONFIG.n_seeds}), budget {POINT_S:g} s a point / "
          f"{FIT_S:g} s a fit, bootstrap depth {CONFIG.tree_depth}, on "
          f"{dev}")
    t0 = time.perf_counter()
    with open(args.out, "w") if args.out else nullcontext() as out:
        rows, checks, notes = run_grid(ns, m=m, device=dev, seed=args.seed,
                                       table2_n=TABLE2_N[args.grid], out=out)
    for line in report(rows, checks, notes):
        print(line)
    print(f"[figures] done in {time.perf_counter() - t0:.1f} s")
    if dev.type == "cuda":
        smi = _smi_line()
        print(smi if smi else "nvidia-smi: not readable")
    return 0


if __name__ == "__main__":
    sys.exit(main())
