"""Synthetic trace generators for the replay harness, counterpart of
``repro/telemetry/loadgen.py``: the same workloads, the same records and
the same rng consumption, so for the same arguments both packages give
equal traces, dict for dict.

The records are in the schema ``telemetry.tracer`` writes from a real
serving run (``launch.serve --trace-out``), so recorded and generated
traces are interchangeable replay inputs. A generated record is an
*arrival*: its ``t`` is when the op arrives (inter-arrival process chosen
by the workload), ``wall_s`` is 0.0 (no timing was observed — the replay
measures it), and the v2 fields carry the workload name, seed and, for
tenant-skewed traffic, the per-tick active-tenant subset.

Workloads (``WORKLOADS``):

steady    Poisson arrivals at a constant ``rate`` — the paper's
          single-stream regime, the baseline every other workload is
          compared against.
bursty    on/off modulated Poisson: within each ``burst_period``
          seconds the first ``burst_duty`` fraction arrives at
          ``rate * burst_factor``, the rest at a trickle. The tail-
          latency stressor: queue depth spikes at burst onsets.
diurnal   rate ramps linearly 0 -> peak -> 0 over the trace (a
          compressed day): behaviour across a full load sweep in one
          replay.
zipf      steady arrivals, but each tick activates a Zipf(a)-weighted
          random tenant subset — heavy tenant skew, the multi-tenant
          fairness stressor. Records carry the ``active`` list so
          replay reproduces the exact masks.

Every workload interleaves a read op (``predict`` for classification,
``intervals`` for regression) every ``predict_every`` observes. All
randomness comes from one ``numpy`` Generator seeded by ``seed``.

Passing a ``robustness.FaultPlan`` as ``faults=`` stamps its traffic and
timing schedule onto the records (tracer schema v3): a value fault at
step s becomes ``rec["fault"] = {"kind", "tenant"}`` on the s-th observe
record, a ``duplicate_arrival`` also picks the earlier observe it
re-delivers (``of_seq``, keyed), and a ``delay`` sets ``rec["delay_s"]``.
The base trace is unchanged by the plan (same rng consumption), so a
faulted trace differs from its fault-free oracle only in the stamped
fields.

    from repro_torch.telemetry import loadgen, write_trace
    recs = loadgen.generate("bursty", ops=512, tenants=8, capacity=128)
    write_trace("bursty.jsonl", recs)
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.telemetry.tracer import (SCHEMA_VERSION, capacity_bucket,
                                          validate_record)

WORKLOADS = ("steady", "bursty", "diurnal", "zipf")


def _rate_at(workload: str, t: float, horizon: float, *, rate: float,
             burst_period: float, burst_duty: float,
             burst_factor: float) -> float:
    """Instantaneous arrival rate of the workload at time ``t``."""
    if workload == "steady" or workload == "zipf":
        return rate
    if workload == "bursty":
        phase = (t % burst_period) / burst_period
        if phase < burst_duty:
            return rate * burst_factor
        # off phase: a trickle, never exactly zero (arrivals must make
        # progress through the off window)
        return max(rate / burst_factor, 1e-3)
    if workload == "diurnal":
        # triangle ramp 0 -> 1 -> 0 across the horizon, floored so the
        # trace tails don't stall
        frac = 0.0 if horizon <= 0 else min(max(t / horizon, 0.0), 1.0)
        ramp = 1.0 - abs(2.0 * frac - 1.0)
        return rate * max(ramp, 0.05)
    raise ValueError(f"unknown workload {workload!r} (known: {WORKLOADS})")


def _zipf_weights(tenants: int, a: float) -> np.ndarray:
    w = 1.0 / np.arange(1, tenants + 1, dtype=np.float64) ** a
    return w / w.sum()


def generate(workload: str, *, ops: int, tenants: int, capacity: int,
             engine: str = "classification", rate: float = 2000.0,
             seed: int = 0, predict_every: int = 16,
             burst_period: float = 0.25, burst_duty: float = 0.2,
             burst_factor: float = 8.0, zipf_a: float = 1.2,
             zipf_active_frac: float = 0.5,
             slo_s: float | None = None,
             faults=None) -> list[dict[str, Any]]:
    """Build ``ops`` schema-valid trace records for one workload.

    ``rate`` is the mean arrival rate (ops/s) of the *trace clock*;
    replay rescales it by ``speedup``. ``predict_every > 0`` interleaves
    one read op (predict/intervals) every that many observes; 0 disables
    reads. ``zipf_active_frac`` sets the expected fraction of tenants
    active per zipf tick (sampled without replacement by Zipf weight —
    low-rank tenants appear rarely). ``faults`` (a
    ``robustness.FaultPlan``) stamps its traffic/timing schedule onto the
    records — see the module docstring. Returns the records (write them
    with ``tracer.write_trace``).
    """
    if workload not in WORKLOADS:
        raise ValueError(f"unknown workload {workload!r} "
                         f"(known: {WORKLOADS})")
    if ops < 1:
        raise ValueError("ops must be >= 1")
    if tenants < 1:
        raise ValueError("tenants must be >= 1")
    read_op = "intervals" if engine == "regression" else "predict"
    rng = np.random.default_rng(seed)
    horizon = ops / rate  # mean-rate horizon, used by the diurnal ramp
    weights = _zipf_weights(tenants, zipf_a) if workload == "zipf" else None
    n_active = (max(1, int(round(zipf_active_frac * tenants)))
                if workload == "zipf" else tenants)

    records: list[dict[str, Any]] = []
    observe_seqs: list[int] = []
    t = 0.0
    since_read = 0
    for seq in range(ops):
        r = _rate_at(workload, t, horizon, rate=rate,
                     burst_period=burst_period, burst_duty=burst_duty,
                     burst_factor=burst_factor)
        t += float(rng.exponential(1.0 / r))
        rec: dict[str, Any] = {
            "schema": SCHEMA_VERSION,
            "seq": seq,
            "t": t,
            "op": "observe",
            "wall_s": 0.0,
            "tenants": tenants,
            "ticks": 1,
            "capacity": int(capacity),
            "cap_bucket": capacity_bucket(capacity),
            "engine": engine,
            "workload": workload,
            "seed": seed,
        }
        if slo_s is not None:
            rec["slo_s"] = float(slo_s)
        if predict_every and since_read >= predict_every:
            rec["op"] = read_op
            del rec["ticks"]
            since_read = 0
        else:
            since_read += 1
            if weights is not None:
                act = rng.choice(tenants, size=n_active, replace=False,
                                 p=weights)
                rec["active"] = sorted(int(s) for s in act)
        if faults is not None and rec["op"] == "observe":
            _stamp_faults(rec, faults, seq, tenants, observe_seqs)
        validate_record(rec)
        records.append(rec)
        if rec["op"] == "observe":
            observe_seqs.append(seq)
    return records


def _stamp_faults(rec: dict[str, Any], faults, seq: int, tenants: int,
                  observe_seqs: list) -> None:
    """Stamp a FaultPlan's schedule for step ``seq`` onto one observe
    record (schema v3 ``fault`` / ``delay_s`` fields); ``observe_seqs``
    holds the earlier observes' seqs. Duck-typed on ``faults.at(site,
    step)`` / ``faults.seed`` so this module needs no robustness import."""
    for f in faults.at("traffic", seq):
        if f.kind == "delay":
            rec["delay_s"] = rec.get("delay_s", 0.0) + float(f.param)
        elif f.kind == "duplicate_arrival":
            if not observe_seqs:
                continue  # nothing earlier to re-deliver
            pick = np.random.default_rng(
                (int(faults.seed), 0xD0B, seq))
            rec["fault"] = {
                "kind": f.kind,
                "tenant": int(f.tenant) % tenants,
                "of_seq": int(observe_seqs[
                    int(pick.integers(len(observe_seqs)))]),
            }
        else:
            rec["fault"] = {"kind": f.kind,
                            "tenant": int(f.tenant) % tenants}


__all__ = ["WORKLOADS", "generate"]
