"""Where the device time of the port's serving goes, on the card.

    python -m repro_torch.launch.profile --trace tick_trace.json
    python -m repro_torch.launch.profile --regression
    python -m repro_torch.launch.profile --measure kde
    python -m repro_torch.launch.profile --measure bootstrap
    python -m repro_torch.launch.profile --kde-layouts
    python src/repro_torch/launch/profile.py --kernel-times
    python -m repro_torch.launch.profile --arch qwen2-1.5b
    python -m repro_torch.launch.profile --telemetry

At a serving cell's shapes (1024 tenants, window 1024, dim 30; k 15 for
classification, k 7 for ``--regression``), fills every tenant's window
through the engine's ``observe_many`` (drift traffic as in
``launch.serve``), then traces 8 evicting ticks and one read of 100
points per tenant with ``torch.profiler``: ``predict``, or for
``--regression`` a steady-state ``intervals`` call (one untraced call
first). For each it prints the host wall time (synchronised), the summed
device time of every kernel and its share of the wall time (the device
busy share: one stream, so kernels do not overlap), and the kernels with
the most device time. ``--measure kde`` instead traces the batch KDE
classifier at the paper's App. E top size (n = 100,000 training points,
dim 30, 2 labels, h = 1): one ``ConformalClassifier.fit`` and one
steady-state ``predict_pvalues`` over 100 test points (one untraced call
first). ``--measure bootstrap`` traces the bootstrap classifier at
``chip_smoke.py`` phase 9's size (n = 2,154, a point of the paper's
n-grid; B 10, depth 5; 10 test points) and adds, for each traced call,
the forest calls made on the card and the bytes they copied to it, per
test point for the read. ``--kde-layouts`` times the ``kde_rowsums`` kernel's two layouts
(grouped, wide) against each other (CUDA events) over a grid of row counts
at n = 100,000, dim 30, 2 labels, in both output forms, and the read's
per-label form against the one-label form over its m * L rows: the
measurement behind ``WIDE_ROWS``.
``--kernel-times`` times ``kde_rowsums`` and ``pairwise_sq_dists`` (CUDA
events) at the batch and serving paths' shapes: the fit's form at m = n =
100,000 (dim 30, 2 labels, h 1, diagonal excluded), the read's per-label
form at m = 100 and 2,000 against the same points, and
``pairwise_sq_dists`` beside ``torch.cdist`` at the serving read's shape
(1024 tenants, 100 queries, window 1024) and at a k-NN fit's row block
(``knn.BLOCK_ELEMS // 100,000`` rows against 100,000), and the serving
reads' kernels at that shape: ``interval_sweep`` (k 7) and
``cp_knn_counts`` (2 labels), on the inputs ``chip_smoke.py`` phase 3
draws for them. It calls only the wrappers' public signatures, so that
run as a file with another tree's ``src`` first on ``PYTHONPATH`` it
times that tree's kernels.
``--telemetry`` prices the engines' instrumentation on the launcher's
tick (one ``observe`` a tick, up to its p-values' copy to the host) at
the classification cell's shapes, windows full: the host-clock median
of 256 ticks of a plain engine, an instrumented one (metrics) and one
with a tracer too, in turns; then each piece alone, 256 calls
synchronised: ``record_chunk`` (the tick stats' copies), the ``timed``
wrapper around an empty body, and ``TickStats.flush`` of 64 recorded
one-tick chunks; and the CUDA launches (``cudaLaunchKernel`` calls) of
8 ticks of each engine, from ``torch.profiler``.
``--arch NAME`` traces the LM conformal-OOD serving path at full width
(bf16, random weights from the seed): one calibration embedding pass over
256 sequences of 512 tokens (one untraced pass first) and one decode step
of 16 requests against a 544-token cache (one untraced step first).
Needs a GPU.
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.predictor import ConformalClassifier
from repro_torch.data.synthetic import make_classification
from repro_torch.kernels import ops
from repro_torch.kernels.kde_score import WIDE_ROWS, kde_rowsums
from repro_torch.launch import serve
from repro_torch.launch.serve import class_drift_traffic, reg_drift_traffic
from repro_torch.models import lm
from repro_torch.regression import RegressionServingEngine
from repro_torch.serving import ServingEngine

S, W, P, QUERIES = 1024, 1024, 30, 100
K_CLASS, K_REG, EPS = 15, 7, 0.1
TICKS, CHUNK, TOP, SEED = 8, 32, 15, 0
N_BATCH = 100_000  # the top of the paper's n-grid (numpy.logspace(1, 5, 13))
N_BOOT, BOOT_QUERIES = 2154, 10  # bootstrap: a point of that grid (phase 9)
HAND_KERNELS = ("stream_tick_class_kernel", "stream_tick_reg_kernel",
                "pairwise_sq_dists_kernel", "cp_knn_counts_kernel",
                "interval_sweep_kernel", "kde_group_kernel",
                "kde_group_rank_kernel", "kde_group_scan_kernel",
                "kde_rowsums_wide_kernel", "kde_sumsq_kernel",
                "pairwise_norms_kernel",
                "flash_attention_kernel", "fa_bf16_kernel")
LM_CALIB, LM_SEQ, LM_REQUESTS, LM_GEN = 256, 512, 16, 32  # smoke phase 7


def device_breakdown(fn, label: str, trace: str | None) -> None:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name][0] += 1
            per_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy = sum(ms for _, ms in per_name.values())
    hand = sum(ms for name, (_, ms) in per_name.items()
               if any(h in name for h in HAND_KERNELS))
    print(f"[{label}] wall {wall_ms:.3f} ms, device {busy:.3f} ms "
          f"(busy {busy / wall_ms:.1%}), hand kernels {hand:.3f} ms "
          f"({hand / max(busy, 1e-9):.1%} of device), "
          f"{sum(c for c, _ in per_name.values())} kernels")
    if busy == 0.0:
        raise RuntimeError("the profiler saw no device time")
    rows = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    for name, (count, ms) in rows:
        print(f"  {ms:10.3f} ms {ms / busy:6.1%} x{count:<6d} {name[:100]}")
    if trace:
        prof.export_chrome_trace(trace)


def forest_line(per: int, what: str) -> None:
    """The bootstrap forest's calls on the card and bytes copied to it
    since the last reset, in all and per ``what``."""
    c = ops.forest_calls()
    fits, preds = c["boot_fit_forest"], c["boot_forest_predict"]
    h2d = c["h2d_bytes"]
    print(f"  forest: {fits} fits + {preds} predictions on the card, "
          f"{h2d} B copied to it; per {what}: {fits / per:.1f} fits, "
          f"{preds / per:.1f} predictions, {h2d / per:.0f} B")


def profile_batch(measure: str, trace: str | None) -> int:
    """The batch classifier's fit and steady-state predict, traced."""
    boot = measure == "bootstrap"
    n, m = (N_BOOT, BOOT_QUERIES) if boot else (N_BATCH, QUERIES)
    X, y = make_classification(n + m, P, seed=SEED)
    X = torch.as_tensor(X, dtype=torch.float32, device="cuda").contiguous()
    y = torch.as_tensor(y, dtype=torch.int32, device="cuda")
    Xtr, ytr, Xq = X[:n], y[:n], X[n:]
    clf = ConformalClassifier(measure, n_labels=2, k=K_CLASS, h=1.0,
                              device="cuda")
    print(f"[profile] {torch.cuda.get_device_name(0)}: batch {measure} "
          f"n={n} dim={P} m={m}")
    clf.fit(Xtr[:1024], ytr[:1024])  # builds the kernels outside the trace
    ops.reset_launch_counts()
    device_breakdown(lambda: clf.fit(Xtr, ytr), f"fit n={n}", trace)
    if boot:
        print(f"  B' = {clf._state.b_prime} shared samples")
        forest_line(1, "fit")
    clf.predict_pvalues(Xq)
    ops.reset_launch_counts()
    device_breakdown(lambda: clf.predict_pvalues(Xq),
                     f"predict_pvalues m={m} (steady state)", None)
    if boot:
        forest_line(m, "test point (both labels' p-values)")
    return 0


def _events_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def kde_layouts() -> int:
    """Grouped against wide layout of ``kde_rowsums`` by row count, in the
    fit's form (one target label a row, two labels grouped, diagonal
    excluded where m == n) and in the read's per-label form; the read's
    per-label form at m = QUERIES against the one-label form over its m *
    L rows. Every pair of layouts must give the same bits."""
    X, y = make_classification(N_BATCH + QUERIES, P, seed=SEED)
    X = torch.as_tensor(X, dtype=torch.float32, device="cuda").contiguous()
    y = torch.as_tensor(y, dtype=torch.int32, device="cuda")
    Xtr, ytr, L = X[:N_BATCH].contiguous(), y[:N_BATCH].contiguous(), 2
    print(f"[kde-layouts] {torch.cuda.get_device_name(0)}: n={N_BATCH} "
          f"dim={P}, WIDE_ROWS={WIDE_ROWS}; ms per launch (CUDA events)")
    for m in (100, 200, 1000, 2000, 4000, 8000, 9000, 10000, 12000, 16000,
              32000, 64000, N_BATCH):
        A, yA = Xtr[:m], ytr[:m]
        diag = m == N_BATCH
        forms = {"fit": (yA, diag), "per-label": (None, False)}
        line = f"  m={m:6d}:"
        for form, (ya, dg) in forms.items():
            run = {lay: (lambda lay=lay, ya=ya, dg=dg: kde_rowsums(
                A, Xtr, ya, ytr, 1.0, dg, L, layout=lay))
                for lay in ("grouped", "wide")}
            if not torch.equal(run["grouped"](), run["wide"]()):
                raise RuntimeError(f"layouts differ at m = {m} ({form})")
            t = {lay: _events_ms(fn, 3 if m > 20000 else 10)
                 for lay, fn in run.items()}
            line += (f"  {form}: grouped {t['grouped']:9.3f} wide "
                     f"{t['wide']:9.3f} wide/grouped "
                     f"{t['wide'] / t['grouped']:7.3f}")
        print(line)
    Xq = X[N_BATCH:]
    labels = torch.arange(L, dtype=torch.int32, device="cuda")
    Xrep = Xq.repeat_interleave(L, 0).contiguous()
    lrep = labels.repeat(QUERIES)
    every = kde_rowsums(Xq, Xtr, None, ytr, 1.0, n_labels=L)
    one = kde_rowsums(Xrep, Xtr, lrep, ytr, 1.0, n_labels=L)
    if not torch.equal(every.reshape(-1), one):
        raise RuntimeError("per-label form differs from the one-label form")
    t_every = _events_ms(
        lambda: kde_rowsums(Xq, Xtr, None, ytr, 1.0, n_labels=L), 20)
    t_one = _events_ms(lambda: kde_rowsums(Xrep, Xtr, lrep, ytr, 1.0,
                                           n_labels=L), 20)
    print(f"  read m={QUERIES} L={L}: per-label form {t_every:.3f} ms, "
          f"one-label form over {QUERIES * L} rows {t_one:.3f} ms "
          "(same bits)")
    return 0


def sweep_inputs(g, S: int = S, m: int = QUERIES, n: int = W, p: int = P):
    """``interval_sweep``'s seven operands at ``(S, m, n, p)`` from ``g``,
    as ``chip_smoke.py`` phase 3 draws them (k-th distances of 6.5 to 8.5
    at dim 30, so many live cells enter their column's list)."""
    dev = "cuda"
    X = torch.randn((S, n, p), generator=g, device=dev)
    a_prime = torch.randn((S, n), generator=g, device=dev)
    kth = 6.5 + 2.0 * torch.rand((S, n), generator=g, device=dev)
    kth_label = torch.randn((S, n), generator=g, device=dev)
    n_live = torch.randint(n // 2, n + 1, (S, 1), generator=g, device=dev)
    live = torch.arange(n, device=dev) < n_live
    Xt = torch.randn((S, m, p), generator=g, device=dev)
    a_test = torch.randn((S, m), generator=g, device=dev)
    return X, a_prime, kth, kth_label, live, Xt, a_test


def counts_inputs(g, S: int = S, m: int = QUERIES, n: int = W, p: int = P,
                  k: int = K_CLASS, L: int = 2):
    """``cp_knn_counts``' six operands at ``(S, m, n, p)``, ``L`` labels,
    from ``g``, as ``chip_smoke.py`` phase 3 draws them (10 % of the
    columns dead: label -1, sum and k-th distance -1e30)."""
    dev = "cuda"
    X = torch.randn((S, n, p), generator=g, device=dev)
    y = torch.randint(0, L, (S, n), generator=g, device=dev,
                      dtype=torch.int32)
    kth = 6.0 + 3.0 * torch.rand((S, n), generator=g, device=dev)
    sums = kth * k * (0.7 + 0.3 * torch.rand((S, n), generator=g,
                                             device=dev))
    dead = torch.rand((S, n), generator=g, device=dev) < 0.1
    y = torch.where(dead, -1, y)
    sums = torch.where(dead, -1e30, sums)
    kth = torch.where(dead, -1e30, kth)
    Xt = torch.randn((S, m, p), generator=g, device=dev)
    alpha = 7.5 * k * (0.7 + 0.3 * torch.rand((S, m, L), generator=g,
                                               device=dev))
    return X, y, sums, kth, Xt, alpha


def kernel_times() -> int:
    """``kde_rowsums``, ``pairwise_sq_dists``, ``interval_sweep`` and
    ``cp_knn_counts`` at the paths' shapes; every output checked finite
    (``interval_sweep``'s, whose empty sets are infinite: free of NaN)."""
    import repro_torch
    from repro_torch.core.measures.knn import BLOCK_ELEMS
    from repro_torch.kernels.cp_update import cp_knn_counts
    from repro_torch.kernels.interval_sweep import interval_sweep
    from repro_torch.kernels.pairwise_dist import pairwise_sq_dists

    X, y = make_classification(N_BATCH + 2000, P, seed=SEED)
    X = torch.as_tensor(X, dtype=torch.float32, device="cuda").contiguous()
    y = torch.as_tensor(y, dtype=torch.int32, device="cuda")
    Xtr, ytr, Xq, L = X[:N_BATCH], y[:N_BATCH], X[N_BATCH:], 2
    print(f"[kernel-times] {torch.cuda.get_device_name(0)}: "
          f"{repro_torch.__file__}; ms per launch (CUDA events)")

    def line(what, fn, iters, ok=lambda out: bool(torch.isfinite(out).all())):
        if not ok(fn()):
            raise RuntimeError(f"{what}: output fails its check")
        print(f"  {what}: {_events_ms(fn, iters):.4f} ms")

    line(f"kde_rowsums fit form m=n={N_BATCH} p={P} L={L} diag excluded",
         lambda: kde_rowsums(Xtr, Xtr, ytr, ytr, 1.0, True, L), 5)
    for m in (100, 2000):
        A = Xq[:m].contiguous()
        line(f"kde_rowsums per-label form m={m} n={N_BATCH}",
             lambda A=A: kde_rowsums(A, Xtr, None, ytr, 1.0, n_labels=L), 20)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = BLOCK_ELEMS // N_BATCH
    for S_, A, B in ((S, torch.randn((S, QUERIES, P), generator=g,
                                     device="cuda"),
                      torch.randn((S, W, P), generator=g, device="cuda")),
                     (1, Xtr[None, :rows], Xtr[None])):
        shape = f"S={S_} m={A.shape[1]} n={B.shape[1]} p={P}"
        line(f"pairwise_sq_dists {shape}", lambda: pairwise_sq_dists(A, B),
             20)
        line(f"torch.cdist {shape}", lambda: torch.cdist(A, B), 20)
    del A, B
    shape = f"S={S} m={QUERIES} n={W} p={P}"
    sweep = sweep_inputs(g)
    line(f"interval_sweep {shape} k={K_REG}",
         lambda: interval_sweep(*sweep, k=K_REG), 20,
         ok=lambda out: not any(bool(o.isnan().any()) for o in out))
    del sweep
    counts = counts_inputs(g)
    line(f"cp_knn_counts {shape} L=2",
         lambda: cp_knn_counts(*counts, n_labels=2), 20)
    return 0


def telemetry_costs() -> int:
    """``--telemetry`` (module doc)."""
    import io

    from repro_torch.telemetry import MetricsRegistry, Tracer

    T = W + 2 * TICKS
    xs, ys, taus, _ = class_drift_traffic(SEED, S, T + 256, P, 2.0)
    kw = dict(n_sessions=S, capacity=W, dim=P, k=K_CLASS, window=W,
              device="cuda")
    engs = {"plain": ServingEngine(**kw),
            "metrics": ServingEngine(**kw, instrument=True,
                                     metrics=MetricsRegistry()),
            "tracer": ServingEngine(**kw, instrument=True,
                                    metrics=MetricsRegistry(),
                                    tracer=Tracer(io.StringIO()))}
    state = engs["plain"].init_state()
    for c0 in range(0, T, CHUNK):
        state, _ = engs["plain"].observe_many(state, xs[c0:c0 + CHUNK],
                                              ys[c0:c0 + CHUNK],
                                              taus[c0:c0 + CHUNK])
    states = {name: state.clone() for name in engs}
    ms = {name: [] for name in engs}
    order = list(engs)
    for i in range(256):
        t = T + i
        for name in order[i % 3:] + order[:i % 3]:
            h0 = time.perf_counter()
            states[name], p = engs[name].observe(states[name], xs[t], ys[t],
                                                 taus[t])
            p.cpu()
            ms[name].append((time.perf_counter() - h0) * 1e3)
    med = {name: float(np.median(v)) for name, v in ms.items()}
    print(f"[telemetry] {torch.cuda.get_device_name(0)}: S={S} window={W} "
          f"dim={P} k={K_CLASS}, one-tick observe up to p.cpu(), median of "
          f"256 in turns (host clock): " + ", ".join(
              f"{n} {v:.3f} ms" for n, v in med.items()))

    tele = engs["metrics"].telemetry
    st = states["metrics"]
    act = torch.ones((1, S), dtype=torch.bool, device=st.D.device)

    def alone(fn, n=256):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - h0) * 1e3 / n

    def empty_timed():
        with tele.timed("observe", signature="probe", ticks=1, tenants=S,
                        capacity=W):
            pass

    def record_then_flush():
        for _ in range(64):
            tele.record_chunk(st, W, act)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        tele.ticks.flush()
        torch.cuda.synchronize()
        return (time.perf_counter() - h0) * 1e3

    tele.ticks.flush_every = 10**9  # no flush inside the record timing
    rec = alone(lambda: tele.record_chunk(st, W, act))
    tele.ticks.flush()
    flush = float(np.median([record_then_flush() for _ in range(16)]))
    tele.ticks.flush_every = 64
    timed = alone(empty_timed)
    print(f"[telemetry] alone, synchronised: record_chunk {rec:.4f} ms, "
          f"timed (empty body) {timed:.4f} ms, flush of 64 recorded "
          f"chunks {flush:.4f} ms ({flush / 64:.4f} ms a tick)")

    for name, eng in engs.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(TICKS):
                t = T + 256 + i - TICKS
                states[name], p = eng.observe(states[name], xs[t], ys[t],
                                              taus[t])
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.name == "cudaLaunchKernel")
        print(f"[telemetry] {name}: {n / TICKS:.1f} cudaLaunchKernel calls "
              f"a tick over {TICKS} ticks")
    tele.drain()
    return 0


def profile_lm(arch: str, trace: str | None) -> int:
    """One calibration embedding pass and one decode step, traced."""
    cfg, params = serve.lm_model(arch, False, SEED, "cuda")
    calib = serve.stream_tokens(cfg, LM_CALIB, LM_SEQ, SEED, 0, "cuda")
    print(f"[profile] {torch.cuda.get_device_name(0)}: {cfg.name} "
          f"{cfg.n_layers} layers d {cfg.d_model} {cfg.dtype}")
    serve.embed(params, cfg, calib)
    device_breakdown(lambda: serve.embed(params, cfg, calib),
                     f"embedding pass {LM_CALIB} x {LM_SEQ}", trace)
    req = serve.request_tokens(cfg, LM_REQUESTS, 1, SEED, "cuda")
    cache = lm.init_cache(cfg, LM_REQUESTS, LM_SEQ + LM_GEN, "cuda")
    lm.decode_step(params, cfg, req, cache, 0)
    device_breakdown(lambda: lm.decode_step(params, cfg, req, cache, LM_SEQ),
                     f"decode step {LM_REQUESTS} requests, cache "
                     f"{LM_SEQ + LM_GEN}", None)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--regression", action="store_true",
                    help="the regression engine's tick and intervals read")
    ap.add_argument("--measure", default=None,
                    choices=("knn", "simplified_knn", "kde", "lssvm",
                             "bootstrap"),
                    help="trace the batch classifier of this measure")
    ap.add_argument("--kde-layouts", action="store_true",
                    help="time kde_rowsums' two layouts by row count")
    ap.add_argument("--kernel-times", action="store_true",
                    help="time kde_rowsums, pairwise_sq_dists, "
                    "interval_sweep and cp_knn_counts at the paths' shapes")
    ap.add_argument("--telemetry", action="store_true",
                    help="price the engines' instrumentation on the "
                    "launcher's one-tick observe")
    ap.add_argument("--arch", default=None,
                    help="trace the LM serving path of this architecture "
                    "(e.g. qwen2-1.5b)")
    ap.add_argument("--trace", default="",
                    help="write the tick (or fit) trace (Chrome JSON) here")
    args = ap.parse_args(argv)
    if args.kde_layouts:
        return kde_layouts()
    if args.kernel_times:
        return kernel_times()
    if args.telemetry:
        return telemetry_costs()
    if args.arch:
        return profile_lm(args.arch, args.trace or None)
    if args.measure:
        return profile_batch(args.measure, args.trace or None)
    T = W + 2 * TICKS
    if args.regression:
        k = K_REG
        eng = RegressionServingEngine(n_sessions=S, capacity=W, dim=P, k=k,
                                      window=W, device="cuda")
        xs, ys, taus, _, _ = reg_drift_traffic(SEED, S, T, P, 2.0)
        read = lambda q: eng.intervals(state, q, epsilon=EPS)  # noqa: E731
        read_name = f"intervals m={QUERIES} (steady state)"
    else:
        k = K_CLASS
        eng = ServingEngine(n_sessions=S, capacity=W, dim=P, k=k, window=W,
                            device="cuda")
        xs, ys, taus, _ = class_drift_traffic(SEED, S, T, P, 2.0)
        read = lambda q: eng.predict(state, q)  # noqa: E731
        read_name = f"predict m={QUERIES}"
    state = eng.init_state()
    for c0 in range(0, W + TICKS, CHUNK):
        c1 = min(c0 + CHUNK, W + TICKS)
        state, _ = eng.observe_many(state, xs[c0:c1], ys[c0:c1],
                                    taus[c0:c1])
    print(f"[profile] {torch.cuda.get_device_name(0)}: S={S} window={W} "
          f"dim={P} k={k}, windows full, {TICKS} evicting ticks")
    sl = slice(W + TICKS, T)
    device_breakdown(
        lambda: eng.observe_many(state, xs[sl], ys[sl], taus[sl]),
        f"observe_many x{TICKS}", args.trace or None)
    Xq = np.random.default_rng(SEED + 1).standard_normal(
        (S, QUERIES, P), dtype=np.float32)
    if args.regression:
        read(Xq)  # the first call grows the allocator's pools
    device_breakdown(lambda: read(Xq), read_name, None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
