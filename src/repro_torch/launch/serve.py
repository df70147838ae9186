"""Multi-tenant online CP serving on the port's engines.

    python -m repro_torch.launch.serve --sessions 1024 --steps 2048 \\
        --window 1024 --capacity 1024 --dim 30 --k 15
    python -m repro_torch.launch.serve --regression --sessions 1024 \\
        --steps 2112 --window 1024 --capacity 1024 --dim 30 --k 7
    python -m repro_torch.launch.serve --measure kde --sessions 4 \\
        --steps 60 --window 32 --dim 4
    python -m repro_torch.launch.serve --sessions 4 --measure bootstrap \\
        --steps 48 --window 24 --boot-b 5 --tree-depth 3

Serves ``--sessions`` concurrent sliding-window CP sessions, one
``observe`` per tick (``--device cuda`` by default), on synthetic drift
traffic made with numpy from ``--seed``: odd tenants shift by ``--drift``
at half time. Classification goes through
``repro_torch.serving.ServingEngine``; ``--regression`` through
``repro_torch.regression.RegressionServingEngine`` on per-tenant linear
labels. Reports session-steps/s, tick p50/p99 (CUDA events on the card),
the launches of each kernel and the tenants flagged by their
simple-mixture martingale; then one read over ``--queries`` points per
tenant: ``predict`` p-values, or ``--regression`` prediction intervals at
``--eps`` with their coverage and median width on fresh labelled points.

The engines run instrumented (``repro_torch.telemetry``), and every
serving mode reports through one metrics registry: op latency
histograms, the device tick counters and the validity monitors (rolling
coverage, p-value uniformity, drift martingales), printed by
``metrics.to_text()``; ``--metrics-out`` writes the same snapshot as JSON
and ``--trace-out`` one JSONL record per engine operation (``--annotate``
adds ``torch.profiler`` ranges). ``--faults SEED`` corrupts the traffic
with a keyed ``FaultPlan.random`` at ``--fault-rate``; ``--guard`` serves
through a ``TickGuard`` (admission, poison-lane quarantine);
``--snapshot-dir`` ends with a snapshot round trip that exits 1 unless
bit-exact (and, with ``--guard``, holds the guard's restore source).
``--shards N`` splits the tenants across N devices
(``core.distributed``): N visible cards (``--device cpu`` has one
device, so only 1 there), bitwise the ``--shards 1`` run; the snapshot
round trip then goes through the ``AsyncShardedSaver`` on N blocks.

    python -m repro_torch.launch.serve --sessions 64 --steps 1100 \\
        --window 1024 --capacity 1024 --dim 30 --k 15 --guard \\
        --snapshot-dir /tmp/snap --faults 0 --metrics-out m.json \\
        --trace-out t.jsonl

``--replay TRACE`` (a JSONL trace file) or ``--replay loadgen:WORKLOAD``
(steady, bursty, diurnal, zipf: ``--steps`` ops over ``--sessions``
tenants at ``--rate`` ops/s) drives one engine from the trace through
``telemetry.replay``, as the JAX launcher's replay mode does: the arrival
clock compressed by ``--speedup`` (``inf``, the default, replays
back-to-back), sojourns held to ``--slo-ms``, reads shed past
``--shed-depth`` and observes deferred past twice it, ``--faults SEED``
stamping value, duplicate and delay faults onto a generated trace at
``--fault-rate``, ``--guard`` a ``TickGuard`` a shard. ``--auto-tune``
chunks the observes by the cost model's ``suggest_chunk``: a model loaded
from ``--cost-model``, else fitted on the trace's timing, else on
``calibrate_engine``'s (``--cost-model-out`` saves it). ``--shards N``
replays N tenant groups on per-shard engines on the one device, merged
into one report. Prints service and sojourn p50/p99 per op, steps/s,
queue depth and the SLO-violation fraction.

    python -m repro_torch.launch.serve --replay loadgen:bursty \\
        --sessions 64 --steps 1100 --capacity 1024 --window 1024 --dim 30 \\
        --k 15 --speedup 1 --rate 2000 --slo-ms 25 --auto-tune \\
        --shed-depth 64

``--audit`` runs the port's invariant audit (``repro_torch.analysis.
audit``) on ``--device`` and writes its report to ``--audit-out``.

``--measure NAME`` (knn, simplified_knn, kde, lssvm, bootstrap) serves
each tenant through its own registry ``ConformalPredictor`` instead, on
the same classification traffic: ``fit`` on a warm-up prefix, then per
tick ``pvalues`` of the new point, ``observe`` it, and ``evict(0)`` once
the window is full. Reports session-steps/s, per-operation ms, the
kernel launches and the bootstrap forest's calls on the card (each call
many CUDA kernels) apart, and the tenants flagged by the running maximum
of their martingale. This is how the measures without a fixed-shape
engine (bootstrap, Algorithm 3, with ``--boot-b`` trees and
``--tree-depth``) are served. The registry's regression measure
(``knn_regression``) is refused, as the JAX launcher refuses it: regression
is served by ``--regression``.

Without ``--sessions`` the launcher serves the language model ``--arch``
(qwen2-1.5b by default; any of ``configs.ARCH_NAMES``: also qwen3-1.7b,
gemma3-1b, granite-34b, mixtral-8x22b, deepseek-v2-236b,
recurrentgemma-9b, xlstm-125m, whisper-base and internvl2-26b; full width
unless ``--reduced``, and refused before any allocation where the weights
do not fit the card's free memory) with a conformal
OOD head, as the JAX launcher's LM mode does: random weights from
``--seed``, ``--calib`` calibration sequences of ``--prompt-len`` tokens
from the synthetic token stream embedded (mean final hidden state) to fit
``ConformalOodDetector(k=7)``; then ``--requests`` requests, the second
half replaced by uniform random tokens, prefilled by teacher-forced
decode steps and extended greedily by ``--gen-tokens``; prints tok/s, each
request's conformal p-value and the in-distribution / corrupted means.
The stream's front-end stubs apply: internvl2-26b's ``--prompt-len``
counts its 256 patch positions, which the text is cut by (the embedding
reads the text only, as the reference's does), and whisper-base's
requests carry their stream batch's frames, whose encoder pass fills the
cross-attention cache before the decode steps.

    python -m repro_torch.launch.serve --arch qwen2-1.5b --calib 256 \\
        --prompt-len 512 --requests 16 --gen-tokens 32
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch._device import resolve
from repro_torch.core.distributed import gather_tenants, visible_devices
from repro_torch.core.lm_conformal import (ConformalOodDetector,
                                          sequence_embedding)
from repro_torch.data.lm_pipeline import TokenStream
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.regression import RegressionServingEngine
from repro_torch.robustness import (VALUE_FAULTS, Fault, FaultInjector,
                                    FaultPlan, TickGuard, corrupt_traffic)
from repro_torch.serving import (AsyncShardedSaver, ServingEngine,
                                 SessionStore, registry)
from repro_torch.telemetry import (CoverageMonitor, DriftMonitor,
                                   EngineTelemetry, MetricsRegistry, Tracer,
                                   UniformityMonitor)


def class_drift_traffic(seed: int, S: int, T: int, dim: int, drift: float):
    """``xs (T, S, dim)`` f32, ``ys (T, S)`` int32, ``taus (T, S)`` f32
    and the ``(S,)`` drifted mask: label-shifted Gaussian features around a
    per-tenant centre; odd tenants move by ``drift`` from tick ``T // 2``
    (the change-detection workload of the paper's App. C.5)."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, 2, (T, S), dtype=np.int32)
    xs = rng.standard_normal((T, S, dim), dtype=np.float32)
    xs += (np.arange(S, dtype=np.float32) * 0.1)[None, :, None]
    xs += ys[..., None]
    drifted = np.arange(S) % 2 == 1
    late = np.arange(T) >= T // 2
    xs[late[:, None] & drifted[None, :]] += np.float32(drift)
    taus = rng.random((T, S), dtype=np.float32)
    return xs, ys, taus, drifted


def reg_drift_traffic(seed: int, S: int, T: int, dim: int, drift: float):
    """``xs (T, S, dim)``, ``ys (T, S)``, ``taus (T, S)`` f32, the
    ``(S,)`` drifted mask and the tenants' weights ``w (S, dim)``: the
    JAX launcher's regression workload, per-tenant linear labels ``y =
    <w_s, x> + 0.1 noise``; odd tenants add ``drift`` to ``y`` from tick
    ``T // 2``."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((S, dim), dtype=np.float32)
    xs = rng.standard_normal((T, S, dim), dtype=np.float32)
    ys = np.einsum("sd,tsd->ts", w, xs)
    ys += 0.1 * rng.standard_normal((T, S), dtype=np.float32)
    drifted = np.arange(S) % 2 == 1
    late = np.arange(T) >= T // 2
    ys[late[:, None] & drifted[None, :]] += np.float32(drift)
    taus = rng.random((T, S), dtype=np.float32)
    return xs, ys, taus, drifted, w


def reg_queries(seed: int, w, m: int, shift):
    """Fresh labelled points from each tenant's current function: ``Xq
    (S, m, dim)``, ``yq (S, m)`` with ``yq = <w_s, x> + shift_s + 0.1
    noise`` (``shift (S,)``: the drift in force)."""
    rng = np.random.default_rng(seed)
    S, dim = w.shape
    Xq = rng.standard_normal((S, m, dim), dtype=np.float32)
    yq = np.einsum("sd,smd->sm", w, Xq) + np.asarray(shift)[:, None]
    yq += 0.1 * rng.standard_normal((S, m), dtype=np.float32)
    return Xq, yq.astype(np.float32)


def interval_coverage(iv, yq):
    """``(S,)`` share of ``yq (S, m)`` inside ``iv (S, m, 2)`` (an empty
    interval covers nothing) and the ``(S, m)`` widths."""
    iv = torch.as_tensor(iv).cpu().numpy()
    hit = (iv[..., 0] <= yq) & (yq <= iv[..., 1])
    return hit.mean(-1), iv[..., 1] - iv[..., 0]


def _telemetry(args):
    """One metrics registry and an optional JSONL tracer per run."""
    metrics = MetricsRegistry()
    tracer = (Tracer(args.trace_out, annotate=args.annotate)
              if args.trace_out else None)
    return metrics, tracer


def _check_shards(shards: int, sessions: int, device) -> None:
    """``--shards`` against ``--sessions`` and the visible devices of
    ``--device``'s kind (the engines raise ``ValueError`` for the same)."""
    if shards < 1:
        raise SystemExit("--shards must be >= 1")
    if shards == 1:
        return
    if sessions % shards:
        raise SystemExit(
            f"--sessions {sessions} is not divisible by --shards "
            f"{shards}; pad the session count")
    n = len(visible_devices(device))
    if shards > n:
        raise SystemExit(
            f"--shards {shards} exceeds the {n} visible device(s); serve "
            "with at most that many shards")


def _chaos_traffic(args, xs, ys, taus, *, mode):
    """``--faults SEED``: the ``(T, S)`` traffic corrupted in place by a
    keyed ``FaultPlan.random`` (NaN / Inf features, out-of-range labels
    and taus)."""
    if args.faults < 0:
        return
    T, S = ys.shape
    plan = FaultPlan.random(args.faults, steps=T, tenants=S,
                            rate=args.fault_rate, kinds=VALUE_FAULTS)
    hits = corrupt_traffic(plan, xs, ys, taus, mode=mode, n_labels=2)
    print(f"[serve] chaos: {len(plan)} traffic fault(s) over {T} steps "
          f"(seed {args.faults}, rate {args.fault_rate}, "
          f"{len({h[1] for h in hits})} tenant(s) hit)")


def _maybe_guard(args, eng, state, metrics, tracer):
    """``--guard``: the engine wrapped in a ``TickGuard``; with
    ``--snapshot-dir`` a first committed snapshot is its lane-restore
    source. Returns ``(engine or guard to tick, guard or None)``."""
    if not args.guard:
        return eng, None
    store = None
    if args.snapshot_dir:
        store = SessionStore(args.snapshot_dir, metrics=metrics,
                             tracer=tracer)
        store.save(0, state, meta=eng.meta(), blocking=True)
    guard = TickGuard(eng, store=store, metrics=metrics)
    src = ("snapshot" if store is not None
           else "none (tripped lanes stay frozen)")
    print(f"[serve] guard: admission + quarantine on (restore source: "
          f"{src})")
    return guard, guard


def _drain_guard(guard, state):
    if guard is None:
        return state
    state = guard.finalize(state)  # flush the deferred poison sweep
    rep = guard.drain()
    print(f"[serve] guard: rejected {sum(rep['rejected'].values())} "
          f"input(s) {dict(rep['rejected'])}, "
          f"{rep['quarantines']} quarantine(s), "
          f"{rep['restores']} restore(s), "
          f"{len(rep['quarantined_lanes'])} lane(s) still frozen")
    return state


def _validity_metrics(pvals, drifted, args, *, engine, metrics,
                      use_max=False):
    """The ``(S, T)`` p-value stream (NaN where a tenant had no tick)
    through the online validity monitors, published as metrics: rolling
    coverage against 1 - eps, the uniformity KS distance, the drift
    martingales (``drift_log_m`` of the first 8 tenants). ``use_max``
    flags drift on the running maximum of log M. Returns the flags."""
    p = np.asarray(pvals, float)
    S, T = p.shape
    cov = CoverageMonitor(args.eps, S, window=T)
    uni = UniformityMonitor(S, window=T)
    drift = DriftMonitor(S, threshold=args.log_threshold)
    for t in range(T):
        col = p[:, t]
        cov.update(col)
        uni.update(col)
        drift.update(col)
    cov.export(metrics, engine=engine)
    uni.export(metrics, engine=engine)
    drift.export(metrics, engine=engine, use_max=use_max)
    stat = drift.max_log_m if use_max else drift.log_m()
    for s in range(min(S, 8)):
        metrics.gauge("drift_log_m", engine=engine, tenant=s,
                      injected=bool(drifted[s])).set(float(stat[s]))
    metrics.gauge("drift_tenants_injected", engine=engine).set(
        int(np.asarray(drifted).sum()))
    return drift.flagged(use_max=use_max)


def _emit_report(args, metrics, tracer, *, mode) -> None:
    """The one report path of every serving mode: the metrics' text
    export, ``--metrics-out`` (JSON) and ``--trace-out`` (JSONL)."""
    print(f"[serve] telemetry ({mode}):")
    for line in metrics.to_text().splitlines():
        print("  " + line)
    if args.metrics_out:
        metrics.dump(args.metrics_out)
        print(f"[serve] metrics -> {args.metrics_out}")
    if tracer is not None:
        tracer.close()
        print(f"[serve] trace -> {tracer.path}")


def _snapshot_roundtrip(args, state, eng, metrics, tracer) -> int:
    """Save the final state, restore it with its engine and compare every
    leaf bitwise (exit code 1 on a mismatch). With ``--faults`` the save
    goes through the ``AsyncShardedSaver`` with one injected transient
    write failure, which its retry absorbs."""
    injector = None
    if args.faults >= 0:
        injector = FaultInjector(FaultPlan(args.faults, (
            Fault("store.write", args.steps, "write_fail", times=1),)),
            metrics=metrics)
    store = SessionStore(args.snapshot_dir, metrics=metrics, tracer=tracer,
                         injector=injector)
    if args.shards > 1 or injector is not None:
        saver = AsyncShardedSaver(store, max(args.shards, 1),
                                  metrics=metrics, seed=args.seed)
        saver.save(args.steps, state, meta=eng.meta())
        saver.close()
    else:
        store.save(args.steps, state, meta=eng.meta(), blocking=True)
    eng2, state2, step = store.restore_engine(device=eng.device)
    whole, whole2 = (gather_tenants(s) for s in (state, state2))
    same = (type(eng2) is type(eng) and eng2.shards == eng.shards and all(
        torch.equal(a, b) for a, b in zip(whole.leaves(), whole2.leaves())))
    print(f"[serve] snapshot@step {step} -> restore "
          f"{'bit-exact' if same else 'MISMATCH'}")
    return 0 if same else 1


def serve_sessions(args) -> int:
    S, T, dim = args.sessions, args.steps, args.dim
    if T < 2:
        raise SystemExit("--steps must be >= 2 (tick 0 is the warm-up)")
    _check_shards(args.shards, S, args.device)
    kind = "regression" if args.regression else "classification"
    metrics, tracer = _telemetry(args)
    tele = dict(instrument=True, metrics=metrics, tracer=tracer,
                device=args.device, shards=args.shards)
    if args.regression:
        eng = RegressionServingEngine(
            n_sessions=S, capacity=args.capacity, dim=dim, k=args.k,
            window=args.window, **tele)
        xs, ys, taus, drifted, w = reg_drift_traffic(args.seed, S, T, dim,
                                                     args.drift)
    else:
        eng = ServingEngine(n_sessions=S, capacity=args.capacity, dim=dim,
                            k=args.k, n_labels=2, window=args.window,
                            **tele)
        xs, ys, taus, drifted = class_drift_traffic(args.seed, S, T, dim,
                                                    args.drift)
    on_card = eng.device.type == "cuda"
    metrics.gauge("serve_shards", mode=kind).set(args.shards)
    where = (eng.device if eng.mesh is None
             else ", ".join(str(d) for d in eng.mesh.flat()))
    print(f"[serve] {kind} engine: {S} sessions x cap {args.capacity} "
          f"(window={args.window}, k={args.k}, dim={dim}, "
          f"shards={args.shards}) on {where}")
    _chaos_traffic(args, xs, ys, taus, mode=kind)
    state = eng.init_state()
    drv, guard = _maybe_guard(args, eng, state, metrics, tracer)
    pvals = np.full((T, S), np.nan, np.float32)
    state, p = drv.observe(state, xs[0], ys[0], taus[0])  # warm-up tick
    ops.reset_launch_counts()
    ticks_ms = []
    # one card's events time a tick; shards on several cards: the host
    # clock around the tick and a synchronisation of every card
    cards = ([] if not on_card else
             list(dict.fromkeys(eng.mesh.flat() if eng.mesh is not None
                                else [eng.device])))
    events = len(cards) == 1
    t0 = time.perf_counter()
    for t in range(1, T):
        if events:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
        else:
            h0 = time.perf_counter()
        state, p = drv.observe(state, xs[t], ys[t], taus[t])
        if events:
            e1.record()
            e1.synchronize()
            ticks_ms.append(e0.elapsed_time(e1))
        else:
            for d in cards:
                torch.cuda.synchronize(d)
            ticks_ms.append((time.perf_counter() - h0) * 1e3)
        pvals[t] = p.cpu().numpy()
    dt = time.perf_counter() - t0
    metrics.gauge("serve_wall_s", mode=kind).set(dt)
    metrics.gauge("serve_session_steps_per_s", mode=kind).set(
        S * (T - 1) / dt)
    clock = ("CUDA events" if events else
             f"host clock, {len(cards)} cards" if on_card else
             "host clock, CPU")
    print(f"[serve] {S * (T - 1) / dt:.1f} session-steps/s over {T - 1} "
          f"ticks; tick p50 {np.percentile(ticks_ms, 50):.3f} ms, p99 "
          f"{np.percentile(ticks_ms, 99):.3f} ms ({clock})")
    eng.telemetry.drain()
    state = _drain_guard(guard, state)

    # the earliest regression p-values are degenerate (k-NN warm-up)
    warm = 2 * args.k if args.regression else 1
    flagged = _validity_metrics(pvals[warm:].T, drifted, args, engine=kind,
                                metrics=metrics)
    print(f"[serve] drift flags: {int(flagged[drifted].sum())}/"
          f"{int(drifted.sum())} drifted tenants, "
          f"{int(flagged[~drifted].sum())}/{int((~drifted).sum())} others")

    if args.regression:
        # the last tick is past T // 2: drifted tenants are shifted
        Xq, yq = reg_queries(args.seed + 1, w, args.queries,
                             np.where(drifted, args.drift, 0.0))
        iv = eng.intervals(state, Xq, epsilon=args.eps)
        cov, width = interval_coverage(iv, yq)
        metrics.gauge("intervals_finite_frac", engine=kind).set(
            float(torch.isfinite(iv).float().mean()))
        metrics.gauge("intervals_median_width", engine=kind).set(
            float(np.nanmedian(width)))
        print(f"[serve] intervals at eps={args.eps}: {tuple(iv.shape)}, "
              f"coverage {cov.mean():.4f} (non-drifted "
              f"{cov[~drifted].mean():.4f}; target >= {1 - args.eps:g}), "
              f"median width {np.nanmedian(width):.4f}, empty share "
              f"{np.isnan(width).mean():.4f}")
    else:
        rng = np.random.default_rng(args.seed + 1)
        Xq = rng.standard_normal((S, args.queries, dim), dtype=np.float32)
        pv = eng.predict(state, Xq)
        print(f"[serve] predict: p-values {tuple(pv.shape)}, finite "
              f"{bool(torch.isfinite(pv).all())}")
    print(f"[serve] kernel launches: {ops.kernel_launches()}")
    rc = 0
    if args.snapshot_dir:
        rc = _snapshot_roundtrip(args, state, eng, metrics, tracer)
    _emit_report(args, metrics, tracer, mode=kind)
    return rc


def serve_registry(args) -> int:
    """Multi-tenant sliding-window serving through the measure registry
    (the counterpart of the JAX launcher's registry mode): a Python loop
    over tenants, one exact-shape ``ConformalPredictor`` each, timed
    through ``EngineTelemetry`` without state accessors. Drift is flagged
    on the running maximum of the log martingale, since a measure that
    retrains on its window re-conforms within a few ticks."""
    spec = registry.get(args.measure)
    if spec.intervals is not None:
        raise SystemExit(
            f"--measure {args.measure} is a regression measure; use "
            "--regression for the engine-served regression path")
    S, T, dim, w = args.sessions, args.steps, args.dim, args.window
    warm = min(w, max(8, T // 4))
    if T <= warm + 2:
        raise SystemExit(f"--steps must exceed the warm-up ({warm + 2})")
    hp = {k: v for k, v in {"k": args.k, "n_labels": 2, "B": args.boot_b,
                            "depth": args.tree_depth}.items()
          if k in spec.defaults}
    xs, ys, _, drifted = class_drift_traffic(args.seed, S, T, dim,
                                             args.drift)
    xs, ys = xs.swapaxes(0, 1), ys.T  # (S, T, dim), (S, T)
    metrics, tracer = _telemetry(args)
    tele = EngineTelemetry(engine="registry", metrics=metrics,
                           tracer=tracer)
    ms = {"fit": [], "pvalues": [], "observe": [], "evict": []}
    on_card = torch.device(args.device).type == "cuda"

    def timed(op, fn):
        with tele.timed(op, signature=args.measure, tenants=1):
            h0 = time.perf_counter()
            out = fn()
            if on_card:
                torch.cuda.synchronize()
            ms[op].append((time.perf_counter() - h0) * 1e3)
        return out

    ops.reset_launch_counts()
    pvals = np.full((S, T - warm), np.nan, np.float32)
    t0 = time.perf_counter()
    for s in range(S):
        cp = registry.ConformalPredictor(args.measure, device=args.device,
                                         **hp)
        timed("fit", lambda: cp.fit(xs[s, :warm], ys[s, :warm]))
        for t in range(warm, T):
            p = timed("pvalues", lambda: cp.pvalues(xs[s, t][None]))
            pvals[s, t - warm] = float(p[0, ys[s, t]])
            timed("observe", lambda: cp.observe(xs[s, t], int(ys[s, t])))
            if cp.n > w:
                timed("evict", lambda: cp.evict(0))
    dt = time.perf_counter() - t0
    metrics.gauge("serve_wall_s", mode="registry",
                  measure=args.measure).set(dt)
    metrics.gauge("serve_session_steps_per_s", mode="registry",
                  measure=args.measure).set(S * (T - warm) / dt)
    print(f"[serve] registry {args.measure}: {S} sessions, window {w}, "
          f"dim {dim}, warm-up {warm} on {args.device}: "
          f"{S * (T - warm) / dt:.1f} session-steps/s; per-operation ms "
          + ", ".join(f"{op} p50 {np.percentile(v, 50):.3f}"
                      for op, v in ms.items() if v)
          + (" (host clock, synchronised)" if on_card else
             " (host clock, CPU)"))
    flagged = _validity_metrics(pvals, drifted, args, engine="registry",
                                metrics=metrics, use_max=True)
    print(f"[serve] drift flags (running max): "
          f"{int(flagged[drifted].sum())}/{int(drifted.sum())} drifted "
          f"tenants, {int(flagged[~drifted].sum())}/"
          f"{int((~drifted).sum())} others")
    print(f"[serve] kernel launches: {ops.kernel_launches()}")
    print(f"[serve] forest calls on the card (plain PyTorch, many CUDA "
          f"kernels each): {ops.forest_calls()}")
    _emit_report(args, metrics, tracer, mode=f"registry:{args.measure}")
    return 0


def serve_replay(args) -> int:
    """Trace replay / load-test mode (``--replay``): drive one engine from
    a trace file or a ``loadgen:<workload>`` spec, report p50/p99 under
    load, and (``--auto-tune``) chunk the observes by the cost model's
    ``suggest_chunk``."""
    from repro_torch.telemetry import (CostModel, calibrate_engine,
                                       capacity_bucket, iter_trace, loadgen,
                                       replay)

    kind = "regression" if args.regression else "classification"
    slo_s = args.slo_ms / 1000.0 if args.slo_ms > 0 else None
    speedup = float(args.speedup)  # accepts "inf"

    if args.replay.startswith("loadgen:"):
        plan = None
        if args.faults >= 0:
            plan = FaultPlan.random(
                args.faults, steps=args.steps, tenants=args.sessions or 8,
                rate=args.fault_rate,
                kinds=VALUE_FAULTS + ("duplicate_arrival", "delay"),
                param=0.001)
            print(f"[serve] chaos: stamping {len(plan)} fault(s) onto "
                  f"the generated trace (seed {args.faults})")
        records = loadgen.generate(
            args.replay.split(":", 1)[1], ops=args.steps,
            tenants=args.sessions or 8, capacity=args.capacity, engine=kind,
            rate=args.rate, seed=args.seed, slo_s=slo_s, faults=plan)
    else:
        records = list(iter_trace(args.replay))
    src = args.replay
    if not records:
        raise SystemExit(f"--replay {src}: the trace has no records")
    tenants = max(int(r.get("tenants", 1)) for r in records)
    cap = max((int(r.get("capacity", 0)) for r in records),
              default=0) or args.capacity
    if not 1 <= args.shards <= tenants:
        raise SystemExit(f"--shards {args.shards} outside [1, the trace's "
                         f"{tenants} tenants]")

    # cost model: load one > fit from the trace's steady timing > probe
    # the engine (loadgen traces record arrivals, not costs)
    model = None
    chunk = None
    if args.cost_model:
        model = CostModel.load(args.cost_model)
        print(f"[serve] cost model <- {args.cost_model}")
    elif args.auto_tune or args.cost_model_out:
        model = CostModel.fit(records, source=src)
        if not model.entries:
            print("[serve] trace carries no steady timing; "
                  "calibrating the engine")
            model = CostModel.fit(
                calibrate_engine(kind, tenants=tenants, capacity=cap,
                                 dim=args.dim, k=args.k, seed=args.seed,
                                 device=args.device),
                source="calibrate")
    if args.auto_tune and model is not None and model.entries:
        chunk = model.suggest_chunk(cap_bucket=capacity_bucket(cap),
                                    engine=kind)
        print(f"[serve] auto-tune: observe_many chunk <- {chunk}")
    if args.cost_model_out and model is not None:
        model.save(args.cost_model_out)
        print(f"[serve] cost model -> {args.cost_model_out}")

    metrics, tracer = _telemetry(args)
    metrics.gauge("serve_shards", mode="replay").set(args.shards)
    res = replay(records, engine=kind, dim=args.dim, k=args.k,
                 window=min(args.window, cap),  # the trace may be smaller
                 speedup=speedup, seed=args.seed, slo_s=slo_s, chunk=chunk,
                 eps=args.eps, metrics=metrics, tracer=tracer,
                 shards=args.shards,
                 shed_depth=args.shed_depth if args.shed_depth > 0 else None,
                 guard=args.guard, device=args.device)
    rep = res.report
    print(f"[serve] replay {src} -> {kind} engine "
          f"({rep['tenants']} tenants x cap {rep['capacity']}, "
          f"{rep['shards']} shard(s)) on {args.device}: "
          f"{rep['ops_replayed']} ops ({rep['ops_skipped']} skipped), "
          f"{rep['ticks']} ticks in {rep['wall_s']:.3f}s "
          f"({rep['steps_per_s']:.0f} session steps/s)")
    if rep["shards"] > 1:
        for sh in rep["per_shard"]:
            print(f"  shard {sh['shard']}: {sh['tenants']} tenants, "
                  f"{sh['session_steps']} steps, occupancy mean "
                  f"{sh['occupancy_mean']:.1f} max {sh['occupancy_max']}")
    for op, d in rep["per_op"].items():
        print(f"  {op:12s} p50={d['p50_s'] * 1e3:8.3f}ms "
              f"p99={d['p99_s'] * 1e3:8.3f}ms "
              f"sojourn_p99={d['sojourn_p99_s'] * 1e3:8.3f}ms "
              f"n={d['count']:.0f}")
    if slo_s is not None:
        print(f"  SLO {args.slo_ms:g}ms: violation fraction "
              f"{rep['slo_violation_frac']:.4f}")
    print(f"  queue depth max {rep['queue_depth_max']:.0f}")
    if rep.get("duplicates_dropped"):
        print(f"  chaos: {rep['duplicates_dropped']} duplicate "
              f"arrival(s) dropped")
    if rep.get("shed_depth") is not None:
        print(f"  shed(depth {rep['shed_depth']}): "
              f"{rep['shed_ops']} read(s) shed, "
              f"{rep['deferred_observes']} observe(s) deferred")
    if "guard" in rep:
        g = rep["guard"]
        print(f"  guard: rejected {sum(g['rejected'].values())} input(s) "
              f"{dict(g['rejected'])}, {g['quarantines']} quarantine(s), "
              f"{g['restores']} restore(s)")
    print(f"[serve] kernel launches: {ops.kernel_launches()}")
    _emit_report(args, metrics, tracer, mode=f"replay:{kind}")
    return 0


OOD_K = 7  # the JAX launcher's ConformalOodDetector(k=7)


def lm_model(arch: str, reduced: bool, seed: int, device, **overrides):
    """``(cfg, params)``: ``arch`` (``reduced()`` if asked, then
    ``overrides``, e.g. a depth cut ``n_layers=, layer_pattern=``) with
    random weights drawn from ``seed`` on ``device``. On a card whose free
    memory cannot hold the weights (``cfg.n_params()`` in
    ``param_dtype``) it raises ``ValueError`` before allocating."""
    cfg = configs.get(arch)
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = cfg.replace(**overrides)
    dev = resolve(device)
    if dev.type == "cuda":
        need = cfg.n_params() * lm.dtype_of(cfg.param_dtype).itemsize
        free = torch.cuda.mem_get_info(dev)[0]
        if need > free:
            raise ValueError(
                f"{cfg.name}: {cfg.n_layers} layers at d {cfg.d_model} hold "
                f"{need / 2**30:.1f} GiB of {cfg.param_dtype} weights, the "
                f"card has {free / 2**30:.1f} GiB free; run --reduced")
    return cfg, lm.init_lm(seed, cfg, device=dev)


def stream_tokens(cfg, batch: int, seq_len: int, seed: int, index: int,
                  device) -> torch.Tensor:
    """Batch ``index`` of ``TokenStream(seed)`` as an int32 tensor."""
    toks = TokenStream(cfg, batch, seq_len, seed=seed).batch_at(index)
    return torch.from_numpy(toks["tokens"]).to(device)


def request_tokens(cfg, batch: int, seq_len: int, seed: int,
                   device) -> torch.Tensor:
    """Requests from ``TokenStream(seed + 1)``, the second half replaced
    by uniform tokens drawn from a generator seeded ``seed + 2``."""
    tokens = stream_tokens(cfg, batch, seq_len, seed + 1, 0, device)
    g = torch.Generator(device=tokens.device).manual_seed(seed + 2)
    tail = tokens[batch // 2:]
    tail.copy_(torch.randint(0, cfg.vocab_size, tail.shape, generator=g,
                             device=tokens.device, dtype=tokens.dtype))
    return tokens


def request_frames(cfg, batch: int, seq_len: int, seed: int, device):
    """An encoder-decoder's request frames, from the batch of
    ``TokenStream(seed + 1)`` the request tokens come from; ``None`` for
    other models."""
    if not cfg.is_encoder_decoder:
        return None
    frames = TokenStream(cfg, batch, seq_len, seed=seed + 1).batch_at(
        0)["frames"]
    return torch.from_numpy(frames).to(device)


def embed(params, cfg, tokens) -> torch.Tensor:
    """Sequence embeddings ``(B, D)`` of ``tokens (B, S)``, one pass."""
    return sequence_embedding(params, cfg, {"tokens": tokens})


def generate(params, cfg, tokens, gen_tokens: int, frames=None):
    """Teacher-forced decode steps over the prompt ``tokens (B, P)``, then
    ``gen_tokens`` greedy ones: the generated ``(B, gen_tokens)``. An
    encoder-decoder first fills its cross cache from ``frames (B, T,
    D)``."""
    B, P = tokens.shape
    cache = lm.init_cache(cfg, B, P + gen_tokens, tokens.device)
    if cfg.is_encoder_decoder:
        if frames is None:
            raise ValueError(f"{cfg.name} decodes against frames")
        cache["cross"] = lm.prefill_cross_cache(params, cfg, frames)
    logits = None
    for i in range(P):
        logits, cache = lm.decode_step(params, cfg, tokens[:, i:i + 1],
                                       cache, i)
    out = []
    cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for g in range(gen_tokens):
        out.append(cur)
        logits, cache = lm.decode_step(params, cfg, cur, cache, P + g)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
    return torch.cat(out, dim=1)


def _timed(fn, device):
    """``(result, seconds)`` on the host clock, synchronised on a card."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def serve_lm(args) -> int:
    try:
        cfg = configs.get(args.arch)
        cfg = cfg.reduced() if args.reduced else cfg
        if cfg.frontend == "vision_stub" and (
                args.prompt_len <= cfg.n_frontend_tokens):
            raise ValueError(
                f"{cfg.name}: --prompt-len {args.prompt_len} leaves no text "
                f"after its {cfg.n_frontend_tokens} patch positions")
        cfg, params = lm_model(args.arch, args.reduced, args.seed,
                               args.device)
    except ValueError as e:
        print(f"[serve] {e}", file=sys.stderr)
        return 2
    dev = params["embed"].device
    B, P, G = args.requests, args.prompt_len, args.gen_tokens
    print(f"[serve] {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.dtype}) on {dev}")
    ops.reset_launch_counts()

    calib = stream_tokens(cfg, args.calib, P, args.seed, 0, dev)
    calib_emb, t_emb = _timed(lambda: embed(params, cfg, calib), dev)
    ood, t_fit = _timed(
        lambda: ConformalOodDetector(k=OOD_K, device=dev).fit(calib_emb),
        dev)
    print(f"[serve] conformal OOD head fit on {args.calib} sequences "
          f"(embedding {t_emb * 1e3:.1f} ms, fit {t_fit * 1e3:.1f} ms)")

    tokens = request_tokens(cfg, B, P, args.seed, dev)
    frames = request_frames(cfg, B, P, args.seed, dev)
    gen, dt = _timed(lambda: generate(params, cfg, tokens, G, frames), dev)
    req_emb = embed(params, cfg, tokens)
    pvals, t_p = _timed(lambda: ood.pvalues(req_emb), dev)
    print(f"[serve] {B} requests x {G} tokens in {dt:.2f}s "
          f"({B * G / dt:.1f} tok/s); p-values {t_p * 1e3:.2f} ms")
    pv, gen = pvals.cpu().numpy(), gen.cpu().numpy()
    for i in range(B):
        flag = "OOD!" if pv[i] <= args.eps else "ok  "
        print(f"  req {i:2d} [{flag}] p={pv[i]:.3f} "
              f"gen={[int(t) for t in gen[i][:6]]}")
    print(f"[serve] mean p in-dist={pv[:B // 2].mean():.3f} "
          f"corrupted={pv[B // 2:].mean():.3f}")
    peak = (f", peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
            "GiB" if dev.type == "cuda" else "")
    print(f"[serve] kernel launches: {ops.kernel_launches()}{peak}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=0,
                    help="concurrent CP sessions (tenants); 0 serves the "
                    "language model --arch")
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="LM mode: the architecture (qwen2-1.5b, "
                    "qwen3-1.7b, gemma3-1b, granite-34b, mixtral-8x22b, "
                    "deepseek-v2-236b, recurrentgemma-9b, xlstm-125m, "
                    "whisper-base, internvl2-26b)")
    ap.add_argument("--reduced", action="store_true",
                    help="LM mode: the tiny same-family config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-tokens", type=int, default=8)
    ap.add_argument("--calib", type=int, default=256,
                    help="LM mode: calibration sequences")
    ap.add_argument("--regression", action="store_true",
                    help="serve k-NN regression CP (linear-label traffic, "
                    "prediction intervals) instead of classification")
    ap.add_argument("--measure", default=None,
                    choices=registry.available(),
                    help="serve each tenant through a registry "
                    "ConformalPredictor of this measure")
    ap.add_argument("--boot-b", type=int, default=5,
                    help="bootstrap ensemble size B (--measure bootstrap)")
    ap.add_argument("--tree-depth", type=int, default=3,
                    help="bootstrap tree depth (--measure bootstrap)")
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--k", type=int, default=7)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--queries", type=int, default=100,
                    help="read query points per tenant")
    ap.add_argument("--eps", type=float, default=0.1,
                    help="miscoverage of the regression intervals; the LM "
                    "mode's OOD flag level")
    ap.add_argument("--drift", type=float, default=2.0)
    ap.add_argument("--log-threshold", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--snapshot-dir", default="",
                    help="sessions mode: end with a snapshot round trip "
                    "here (exit 1 unless bit-exact); with --guard, a first "
                    "snapshot is the quarantine's restore source")
    ap.add_argument("--shards", type=int, default=1,
                    help="shard the tenant axis across N devices (sessions "
                    "modes: N visible cards, bitwise --shards 1; --replay: "
                    "N per-shard engines on the one device with merged "
                    "metrics)")
    ap.add_argument("--metrics-out", default="",
                    help="write the end-of-run metrics snapshot (the one "
                    "the report prints) to this JSON file")
    ap.add_argument("--trace-out", default="",
                    help="record one JSONL trace record per engine "
                    "operation to this file (repro_torch.telemetry.tracer "
                    "schema)")
    ap.add_argument("--annotate", action="store_true",
                    help="with --trace-out: wrap traced operations in "
                    "torch.profiler.record_function ranges")
    ap.add_argument("--faults", type=int, default=-1, metavar="SEED",
                    help="sessions mode: corrupt the traffic with a keyed "
                    "FaultPlan.random of this seed (and, with "
                    "--snapshot-dir, fail the final save once); --replay "
                    "loadgen: stamp value, duplicate and delay faults onto "
                    "the generated trace; -1 (the default) disables")
    ap.add_argument("--fault-rate", type=float, default=0.02,
                    help="per-step fault probability for --faults")
    ap.add_argument("--guard", action="store_true",
                    help="sessions and replay modes: serve through a "
                    "TickGuard (admission + poison-lane quarantine; restore "
                    "from --snapshot-dir when set)")
    ap.add_argument("--replay", default="",
                    help="replay a JSONL trace file, or synthesise one with "
                    "loadgen:<workload> (steady|bursty|diurnal|zipf; --steps "
                    "ops, --sessions tenants)")
    ap.add_argument("--speedup", default="inf",
                    help="--replay: compress the trace's inter-arrival times "
                    "by this factor; 'inf' (the default) replays "
                    "back-to-back")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="--replay: latency SLO in ms; report the share of "
                    "ops whose sojourn exceeds it (0: no SLO)")
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="--replay loadgen: mean arrival rate, ops/s of the "
                    "trace clock (rescaled by --speedup)")
    ap.add_argument("--auto-tune", action="store_true",
                    help="--replay: chunk the observes by the fitted cost "
                    "model's suggest_chunk")
    ap.add_argument("--cost-model", default="",
                    help="--replay: load a fitted cost model JSON instead of "
                    "fitting or calibrating one")
    ap.add_argument("--cost-model-out", default="",
                    help="--replay: save the fitted cost model JSON here")
    ap.add_argument("--shed-depth", type=int, default=0,
                    help="--replay: shed reads once the backlog exceeds this "
                    "depth and defer observes past twice it (0: no "
                    "shedding)")
    ap.add_argument("--audit", action="store_true",
                    help="run the invariant audit (repro_torch.analysis."
                    "audit) on --device and exit; nonzero on a violation")
    ap.add_argument("--audit-out", default="audit_report.json",
                    help="--audit: the JSON report's path")
    args = ap.parse_args(argv)
    if args.audit:
        from repro_torch.analysis import audit as audit_m
        return audit_m.main(["--out", args.audit_out, "--device",
                             args.device])
    if args.replay:
        if args.measure:
            raise SystemExit("--replay and --measure are exclusive")
        return serve_replay(args)
    if args.sessions > 0:
        if args.measure:
            if args.guard or args.faults >= 0:
                raise SystemExit("--guard/--faults cover the engine "
                                 "modes, not --measure")
            return serve_registry(args)
        return serve_sessions(args)
    if args.regression or args.measure:
        raise SystemExit("--regression and --measure need --sessions N")
    return serve_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
