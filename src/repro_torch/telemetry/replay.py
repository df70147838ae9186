"""Trace replay harness, counterpart of ``repro/telemetry/replay.py``:
re-drive the port's serving engines from a trace.

The decoding half of the tracer: a recorded (``launch.serve
--trace-out``) or generated (``telemetry.loadgen``) JSONL trace is
replayed against either serving engine — classification
(``repro_torch.serving``) or regression (``repro_torch.regression``) —
keeping the trace's inter-arrival timing (or compressing it by
``speedup``), and reporting p50/p99 per-op latency (device-true: the
engines run with ``sync_timing=True``, so every timed operation ends in
a synchronisation of its stream), session steps/s, queue depth and the
SLO-violation fraction, all through the ordinary ``MetricsRegistry``.

Semantics
---------
* A record's ``t`` is its *arrival* on the trace clock; replay arrival
  is ``t / speedup``. The loop sleeps until a batch's last arrival,
  dispatches synchronously, and measures each record's **sojourn**
  (completion - arrival): queueing delay during bursts shows up in the
  p99 as it would in a live server. ``speedup=inf`` drops the clock
  (every op back-to-back): sojourns then equal service times and queue
  depth degenerates to the remaining backlog — the mode for determinism
  tests.
* Replayed traffic is synthesised on the host with numpy from ``(seed,
  record seq, tick)``, as in JAX, and copied to the engines' device once
  a dispatch (through pinned memory on a card, so the copy does not
  synchronise): same trace + same seed => bitwise the same final state,
  independent of wall-clock jitter and of the ``chunk`` coalescing below
  (the engines' observe_many == observe x T).
* ``chunk=N`` coalesces runs of consecutive single-tick ``observe``
  records into one ``observe_many`` dispatch of up to N ticks — the
  knob ``costmodel.suggest_chunk`` tunes. Records keep their own
  arrival times, so batching's latency cost (early arrivals wait for
  the batch to fill) is measured, not hidden.
* Ops with no engine counterpart (``fit``, ``evict`` — eviction is the
  sliding window's job — ``grow``, ``snapshot_*``) are skipped and
  counted in ``replay_skipped_ops_total``. Read ops map onto the
  engine's read path (classification: ``predict``; regression:
  ``intervals``).

Fault schedule (tracer schema v3, ``robustness.faults``)
--------------------------------------------------------
* ``duplicate_arrival`` records are at-least-once re-deliveries of an
  earlier event id: replay drops them at ingest
  (``replay_duplicates_dropped_total``), so the final state is bitwise
  the never-duplicated trace's.
* ``delay_s`` shifts a record's arrival to ``t + delay_s``; batches
  wait for their latest member.
* Traffic value faults (``fault.kind`` in ``VALUE_FAULTS``) corrupt that
  record's synthesised tick for ``fault["tenant"]`` — what the
  ``guard=True`` admission check is there to catch.

Overload controls
-----------------
``shed_depth=N`` enables queue-depth load shedding: when the backlog
exceeds N, arriving READ ops are shed (counted per op in
``replay_shed_ops_total``, never dispatched); past ``2 * N`` observes
are DEFERRED (``replay_deferred_observes_total``) into a pending queue
flushed every ``defer_flush`` ticks, before any dispatched read (reads
see all prior writes), and at the end of the trace. Observe order is
kept, so the final state stays bitwise the unshed replay's; deferred
records pay their true (larger) sojourn.

``shards > 1`` replays contiguous tenant groups against per-shard
engines on the one device, each with its own registry, merged into the
report (the multi-process collection shape). It is not the
device-sharded engine (``ServingEngine(shards=N)``, ``Fleet(shards=N)``,
``core.distributed``), which splits one engine's tenants across devices.
"""
from __future__ import annotations

import io
import json
import math
import time
from typing import Any, Iterable

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.tracer import Tracer

_DRIVE_OPS = frozenset({"observe", "observe_many"})
_READ_OPS = frozenset({"predict", "intervals", "pvalues"})


class ReplayResult:
    """Outcome of one replay: the report dict, the final engine state, and
    the engine and metrics that produced it (for determinism checks and
    follow-up reads). Sharded replays (``shards > 1``) concatenate the
    per-shard states leaf by leaf back into the full (S, ...) state —
    bitwise the unsharded replay's — and ``engine`` holds the list of
    per-shard engines."""

    def __init__(self, report: dict[str, Any], state, engine, metrics):
        self.report = report
        self.state = state
        self.engine = engine
        self.metrics = metrics


def _make_engine(kind: str, *, tenants, capacity, window, dim, k,
                 n_labels, metrics, tracer, device):
    """An instrumented engine whose timed operations synchronise, so
    their times and the replay's completion times are device-true."""
    tele = dict(instrument=True, metrics=metrics, tracer=tracer,
                sync_timing=True, device=device)
    if kind == "regression":
        from repro_torch.regression import RegressionServingEngine
        return RegressionServingEngine(
            n_sessions=tenants, capacity=capacity, dim=dim, k=k,
            window=window, **tele)
    from repro_torch.serving import ServingEngine
    return ServingEngine(
        n_sessions=tenants, capacity=capacity, dim=dim, k=k,
        n_labels=n_labels, window=window, **tele)


def _on(device: torch.device, arr: np.ndarray) -> torch.Tensor:
    """``arr`` on ``device``; on a card through pinned memory, so the copy
    is queued on the stream without a host synchronisation."""
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _tick_traffic(seed: int, seq: int, tick: int, S: int, dim: int,
                  kind: str):
    """One tick of deterministic synthetic traffic for record ``seq``."""
    rng = np.random.default_rng((seed, seq, tick))
    x = rng.standard_normal((S, dim)).astype(np.float32)
    if kind == "regression":
        y = rng.standard_normal(S).astype(np.float32)
    else:
        y = (rng.random(S) < 0.5).astype(np.int32)
    tau = rng.random(S).astype(np.float32)
    return x, y, tau


def _plan_batches(records: list[dict[str, Any]],
                  chunk: int | None) -> list[list[int]]:
    """Group record indices into dispatch batches.

    Read ops and multi-tick observe_many records dispatch alone;
    consecutive single-tick observes coalesce up to ``chunk``.
    """
    batches: list[list[int]] = []
    run: list[int] = []
    for i, rec in enumerate(records):
        single_obs = rec["op"] == "observe" and rec.get("ticks", 1) == 1
        if chunk and chunk > 1 and single_obs:
            run.append(i)
            if len(run) >= chunk:
                batches.append(run)
                run = []
            continue
        if run:
            batches.append(run)
            run = []
        batches.append([i])
    if run:
        batches.append(run)
    return batches


def _cat_states(states):
    """Per-shard states concatenated leaf by leaf on the tenant axis."""
    leaves = [torch.cat(ls, dim=0) for ls in zip(*(s.leaves()
                                                   for s in states))]
    return type(states[0]).from_leaves(leaves)


def replay(records: Iterable[dict[str, Any]], *,
           engine: str = "classification", dim: int = 8, k: int = 7,
           n_labels: int = 2, capacity: int | None = None,
           window: int | None = None, speedup: float = math.inf,
           seed: int = 0, slo_s: float | None = None,
           chunk: int | None = None, eps: float = 0.1,
           metrics: MetricsRegistry | None = None,
           tracer: Tracer | None = None, shards: int = 1,
           shed_depth: int | None = None, defer_flush: int = 64,
           guard: bool = False, device=None) -> ReplayResult:
    """Replay a trace against one engine; see the module doc.

    ``records`` may be a list or a generator (``tracer.iter_trace``);
    geometry defaults come from the trace (``tenants`` / ``capacity``
    maxima), overridable per argument. ``slo_s`` is the default latency
    objective; a record's own ``slo_s`` field wins. Returns a
    ``ReplayResult`` whose ``report`` carries p50/p99 per op, steps/s,
    queue depth and the SLO-violation fraction.

    ``shards > 1`` partitions the tenant axis into contiguous groups,
    replays each against its own engine with its own metrics registry,
    and merges the per-shard registries into one report with
    ``MetricsRegistry.merge``. Traffic is still synthesised at full
    width and sliced per shard, and the trace's ``active`` masks
    partition with the tenants, so the concatenated final state is
    bitwise the unsharded replay's. The report gains ``shards`` and
    ``per_shard`` (tenants, session steps, occupancy per shard).

    ``shed_depth`` / ``defer_flush`` enable load shedding and
    ``guard=True`` wraps every shard engine in a
    ``robustness.TickGuard`` (admission + quarantine; the report gains a
    merged ``guard`` section) — module doc for both. ``device``: where
    the engines run, ``cuda`` by default (raises without a GPU).
    """
    if speedup <= 0:
        raise ValueError("speedup must be > 0 (math.inf compresses)")
    dev = resolve(device)
    metrics = metrics if metrics is not None else MetricsRegistry()
    all_recs = list(records)

    def _is_dup(r):
        return r.get("fault", {}).get("kind") == "duplicate_arrival"

    n_dups = sum(1 for r in all_recs if _is_dup(r))
    if n_dups:  # at-least-once delivery: drop re-delivered event ids
        metrics.counter("replay_duplicates_dropped_total").inc(n_dups)
        all_recs = [r for r in all_recs if not _is_dup(r)]
    played = [r for r in all_recs if r["op"] in _DRIVE_OPS | _READ_OPS]
    for r in all_recs:
        if r["op"] not in _DRIVE_OPS | _READ_OPS:
            metrics.counter("replay_skipped_ops_total", op=r["op"]).inc()
    if not played:
        raise ValueError("trace contains no replayable ops")

    S = max(int(r.get("tenants", 1)) for r in played)
    if not 1 <= shards <= S:
        raise ValueError(f"shards {shards} outside [1, tenants={S}]")
    cap = capacity or max((int(r.get("capacity", 0)) for r in played),
                          default=0) or 128
    cap = max(cap, k + 1)
    window = window if window is not None else max(k, cap // 2)
    cuts = [S * i // shards for i in range(shards + 1)]
    shard_metrics = ([metrics] if shards == 1
                     else [MetricsRegistry() for _ in range(shards)])
    engs = [_make_engine(engine, tenants=cuts[i + 1] - cuts[i],
                         capacity=cap, window=window, dim=dim, k=k,
                         n_labels=n_labels, metrics=shard_metrics[i],
                         tracer=tracer, device=dev)
            for i in range(shards)]
    observers: list[Any] = engs
    if guard:
        from repro_torch.robustness.guard import TickGuard
        observers = [TickGuard(engs[i], metrics=shard_metrics[i])
                   for i in range(shards)]
    batches = _plan_batches(played, chunk)

    # ---- warm-up: one throwaway dispatch per distinct chunk length and one
    # read, so every timed dispatch below is steady-state (the kernel
    # library loaded, the allocator grown). Warm-up traffic comes from a
    # disjoint seq namespace; the warmed state is discarded.
    tick_counts = sorted({
        sum(played[i].get("ticks", 1) for i in b)
        for b in batches if played[b[0]]["op"] in _DRIVE_OPS})
    warm_reads = any(played[b[0]]["op"] in _READ_OPS for b in batches)
    for si, eng in enumerate(engs):
        lo, hi = cuts[si], cuts[si + 1]
        warm_state = eng.init_state()
        for wi, T in enumerate(tick_counts):
            xs, ys, taus = (_on(dev, a)[:, lo:hi] for a in _stack_ticks(
                [(10 ** 9 + wi, j) for j in range(T)], seed, S, dim,
                engine))
            warm_state, _ = observers[si].observe_many(warm_state, xs, ys,
                                                     taus)
        if warm_reads:
            _read(eng, warm_state, engine, seed, 10 ** 9, dim, eps, dev)
        del warm_state
        eng.reset_occupancy()
        if eng.telemetry is not None:  # keep warm-up out of the tick stats
            eng.telemetry.ticks.reset()

    states = [eng.init_state() for eng in engs]
    arrivals = ([0.0] * len(played) if math.isinf(speedup)
                else [(r["t"] + r.get("delay_s", 0.0)) / speedup
                      for r in played])
    qhist = metrics.histogram(
        "replay_queue_depth",
        bounds=tuple(float(2 ** e) for e in range(0, 17)))
    slo_total = 0
    slo_checked = 0
    ticks_total = 0
    steps_total = 0
    arrived_ptr = 0
    completed = 0
    shed_total = 0
    deferred_total = 0
    pending: list[list[int]] = []  # deferred observe batches, in order
    pending_ticks = 0
    t0 = time.perf_counter()

    def _account(batch, done, service):
        nonlocal slo_total, slo_checked, completed
        for i in batch:
            rec = played[i]
            sojourn = (service if math.isinf(speedup)
                       else done - arrivals[i])
            metrics.histogram("replay_sojourn_s", op=rec["op"]).observe(
                sojourn)
            metrics.counter("replay_ops_total", op=rec["op"]).inc()
            slo = rec.get("slo_s", slo_s)
            if slo is not None:
                slo_checked += 1
                if sojourn > slo:
                    slo_total += 1
        completed += len(batch)

    def _dispatch_observes(batch):
        nonlocal ticks_total, steps_total
        keys = [(played[i]["seq"], j) for i in batch
                for j in range(played[i].get("ticks", 1))]
        xs, ys, taus = _stack_ticks(keys, seed, S, dim, engine)
        _corrupt_batch(xs, ys, taus, [played[i] for i in batch],
                       engine, n_labels)
        active = _stack_active([played[i] for i in batch], S)
        xs_d, ys_d, taus_d, act_d = (_on(dev, a)
                                     for a in (xs, ys, taus, active))
        for si in range(shards):
            lo, hi = cuts[si], cuts[si + 1]
            states[si], _p = observers[si].observe_many(
                states[si], xs_d[:, lo:hi], ys_d[:, lo:hi],
                taus_d[:, lo:hi], active=act_d[:, lo:hi])
        ticks_total += len(keys)
        steps_total += int(active.sum())

    def _flush_pending():
        """Dispatch the deferred observe batches (original batch
        shapes, original order: bitwise the same final state)."""
        nonlocal pending, pending_ticks
        if not pending:
            return
        d0 = time.perf_counter()
        for pb in pending:
            _dispatch_observes(pb)
        done = time.perf_counter() - t0
        service = time.perf_counter() - d0
        for pb in pending:
            _account(pb, done, service)
        pending = []
        pending_ticks = 0

    for batch in batches:
        recs = [played[i] for i in batch]
        op = recs[0]["op"]
        if not math.isinf(speedup):
            # wait for the batch's LATEST member (an injected delay_s can
            # put it after the batch-closing record)
            last_arr = max(arrivals[i] for i in batch)
            wait = last_arr - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
        now = time.perf_counter() - t0
        while arrived_ptr < len(played) and arrivals[arrived_ptr] <= now:
            arrived_ptr += 1
        backlog = max(arrived_ptr, batch[-1] + 1) - completed
        qhist.observe(backlog)

        if op in _DRIVE_OPS:
            if shed_depth is not None and backlog > 2 * shed_depth:
                pending.append(batch)
                pending_ticks += sum(played[i].get("ticks", 1)
                                     for i in batch)
                deferred_total += len(batch)
                metrics.counter("replay_deferred_observes_total").inc(
                    len(batch))
                if pending_ticks >= defer_flush:
                    _flush_pending()
                continue
            _flush_pending()  # observes stay in arrival order
            d0 = time.perf_counter()
            _dispatch_observes(batch)
            done = time.perf_counter() - t0
            _account(batch, done, time.perf_counter() - d0)
        else:
            if shed_depth is not None and backlog > shed_depth:
                # shed reads first: cheaper to drop, no state impact
                shed_total += len(batch)
                metrics.counter("replay_shed_ops_total", op=op).inc(
                    len(batch))
                completed += len(batch)
                continue
            _flush_pending()  # a served read sees all prior writes
            d0 = time.perf_counter()
            for si, eng in enumerate(engs):
                _read(eng, states[si], engine, seed, recs[0]["seq"], dim,
                      eps, dev)
            done = time.perf_counter() - t0
            _account(batch, done, time.perf_counter() - d0)
    _flush_pending()
    wall = time.perf_counter() - t0

    # ---- per-shard accounting + registry merge -----------------------------
    per_shard = []
    for si, eng in enumerate(engs):
        tot = eng.telemetry.ticks.drain() if eng.telemetry else {}
        ticks_si = tot.get("ticks", 0)
        per_shard.append({
            "shard": si,
            "tenants": cuts[si + 1] - cuts[si],
            "session_steps": ticks_si,
            "occupancy_mean": (tot.get("occupancy_sum", 0) / ticks_si
                               if ticks_si else math.nan),
            "occupancy_max": tot.get("occupancy_max", 0),
        })
    if shards > 1:
        for sm in shard_metrics:
            metrics.merge(sm)

    # ---- report ------------------------------------------------------------
    engine_label = ("regression" if engine == "regression"
                    else "classification")
    per_op: dict[str, dict[str, float]] = {}
    for op in sorted({r["op"] for r in played}):
        eng_op = _engine_op(op, engine)
        h = metrics.histogram(f"engine_{eng_op}_wall_s",
                              engine=engine_label)
        s = metrics.histogram("replay_sojourn_s", op=op).snapshot()
        per_op[op] = {
            "p50_s": h.quantile(0.5), "p99_s": h.quantile(0.99),
            "sojourn_p50_s": s["p50"], "sojourn_p99_s": s["p99"],
            "count": s["count"],
        }
    viol_frac = slo_total / slo_checked if slo_checked else math.nan
    metrics.counter("replay_slo_violations_total").inc(slo_total)
    metrics.gauge("replay_slo_violation_frac").set(viol_frac)
    metrics.gauge("replay_wall_s").set(wall)
    metrics.gauge("replay_steps_per_s").set(
        steps_total / wall if wall > 0 else math.nan)
    metrics.gauge("replay_ticks_total").set(ticks_total)
    metrics.gauge("replay_queue_depth_max").set(
        qhist.max if qhist.count else 0.0)
    report = {
        "engine": engine,
        "tenants": S,
        "capacity": cap,
        "window": window,
        "ops_replayed": len(played),
        "ops_skipped": len(all_recs) - len(played),
        "ticks": ticks_total,
        "session_steps": steps_total,
        "wall_s": wall,
        "steps_per_s": steps_total / wall if wall > 0 else math.nan,
        "speedup": speedup,
        "chunk": chunk,
        "slo_s": slo_s,
        "slo_violation_frac": viol_frac,
        "queue_depth_max": float(qhist.max) if qhist.count else 0.0,
        "per_op": per_op,
        "shards": shards,
        "per_shard": per_shard,
        "shed_depth": shed_depth,
        "shed_ops": shed_total,
        "deferred_observes": deferred_total,
        "duplicates_dropped": n_dups,
    }
    if guard:
        gtot: dict[str, Any] = {"rejected": {}, "quarantines": 0,
                                "restores": 0, "quarantined_lanes": []}
        for si, g in enumerate(observers):
            states[si] = g.finalize(states[si])  # flush the deferred sweep
            d = g.drain()
            for kind, v in d["rejected"].items():
                gtot["rejected"][kind] = gtot["rejected"].get(kind, 0) + v
            gtot["quarantines"] += d["quarantines"]
            gtot["restores"] += d["restores"]
            gtot["quarantined_lanes"] += [
                cuts[si] + lane for lane in d["quarantined_lanes"]]
        report["guard"] = gtot
    if shards == 1:
        state, eng_out = states[0], engs[0]
    else:
        state, eng_out = _cat_states(states), engs
    return ReplayResult(report, state, eng_out, metrics)


def _engine_op(trace_op: str, engine: str) -> str:
    """The engine op a trace op lands on (reads are remapped)."""
    if trace_op in _DRIVE_OPS:
        return "observe_many"
    return "intervals" if engine == "regression" else "predict"


def _corrupt_batch(xs, ys, taus, recs: list[dict[str, Any]], kind: str,
                   n_labels: int) -> None:
    """Apply each record's stamped traffic value fault (schema v3
    ``fault`` field) to its rows of the stacked tick arrays, in place."""
    if not any("fault" in r for r in recs):
        return
    from repro_torch.robustness.faults import VALUE_FAULTS, poisoned_values

    mode = "regression" if kind == "regression" else "classification"
    off = 0
    for r in recs:
        T = r.get("ticks", 1)
        f = r.get("fault")
        if f and f.get("kind") in VALUE_FAULTS:
            lane = int(f.get("tenant", 0)) % xs.shape[1]
            xv, yv, tv = poisoned_values(f["kind"], mode=mode,
                                         n_labels=n_labels)
            for t in range(off, off + T):
                if xv is not None:
                    xs[t, lane, 0] = xv
                if yv is not None:
                    ys[t, lane] = yv
                if tv is not None:
                    taus[t, lane] = tv
        off += T


def _stack_ticks(keys: list[tuple[int, int]], seed: int, S: int, dim: int,
                 kind: str):
    cols = [_tick_traffic(seed, sq, j, S, dim, kind) for sq, j in keys]
    xs = np.stack([c[0] for c in cols])
    ys = np.stack([c[1] for c in cols])
    taus = np.stack([c[2] for c in cols])
    return xs, ys, taus


def _stack_active(recs: list[dict[str, Any]], S: int) -> np.ndarray:
    rows = []
    for rec in recs:
        T = rec.get("ticks", 1)
        if "active" in rec:
            row = np.zeros(S, bool)
            row[[s for s in rec["active"] if s < S]] = True
        else:
            row = np.ones(S, bool)
        rows.extend([row] * T)
    return np.stack(rows)


def _read(eng, state, kind: str, seed: int, seq: int, dim: int,
          eps: float, device: torch.device, m: int = 4):
    rng = np.random.default_rng((seed, seq))
    xq = _on(device, rng.standard_normal((m, dim)).astype(np.float32))
    if kind == "regression":
        return eng.intervals(state, xq, eps)
    return eng.predict(state, xq)


def calibrate_engine(engine: str = "classification", *, tenants: int = 8,
                     capacity: int = 128, window: int | None = None,
                     dim: int = 8, k: int = 7, n_labels: int = 2,
                     chunks: tuple[int, ...] = (1, 4, 16, 64),
                     reps: int = 3, seed: int = 0,
                     device=None) -> list[dict[str, Any]]:
    """Probe observe_many at several chunk lengths; return the trace.

    The quick way to get timing data when the input trace has none (a
    loadgen trace records arrivals, not costs): a few synchronised
    dispatches per chunk length, recorded through the ordinary tracer,
    ready for ``costmodel.CostModel.fit``. The first dispatch at each
    length is flagged ``compile`` and left out of the fit. ``device``:
    ``cuda`` by default (raises without a GPU).
    """
    dev = resolve(device)
    buf = io.StringIO()
    tr = Tracer(buf)
    window = window if window is not None else max(k, capacity // 2)
    eng = _make_engine(engine, tenants=tenants, capacity=capacity,
                       window=window, dim=dim, k=k, n_labels=n_labels,
                       metrics=MetricsRegistry(), tracer=tr, device=dev)
    state = eng.init_state()
    for ci, T in enumerate(sorted(set(chunks))):
        for r in range(reps + 1):  # +1: the first call, flagged compile
            xs, ys, taus = _stack_ticks(
                [(ci * (reps + 1) + r, j) for j in range(T)],
                seed, tenants, dim, engine)
            state, _ = eng.observe_many(
                state, *(_on(dev, a) for a in (xs, ys, taus)))
    tr.close()
    return [json.loads(line) for line in buf.getvalue().splitlines()]


__all__ = ["ReplayResult", "replay", "calibrate_engine"]
