"""JSONL per-op trace recorder for the serving hot path, counterpart of
``repro/telemetry/tracer.py`` with the same schema: a port trace passes
the JAX ``validate_trace_file`` and the other way round.

One JSON object per line, one line per engine-level operation. The file
is the recording half of the ROADMAP's trace-driven benchmark: a replay
harness can re-drive the engines from the ``op``/``ticks``/``tenants``
sequence, and the timing fields calibrate per-bucket cost models.

Schema (``TRACE_SCHEMA``) — every record carries the required fields;
optional fields appear when the recorder knows them:

required
    schema      int   trace format version (<= SCHEMA_VERSION; v1 files
                      stay readable — v2 only *adds* optional fields)
    seq         int   per-tracer monotone record index
    t           float seconds since tracer start (host clock). Replay
                      treats this as the op's arrival time.
    op          str   one of OP_KINDS
    wall_s      float host wall time around the dispatch. A CUDA launch
                      is async: unless the caller synchronized, this is
                      enqueue + host-side time, not device time (the
                      per-op histogram of synchronized loops — e.g. the
                      launcher's per-tick loop, which fetches p-values
                      every tick — is device-true). Generated (loadgen)
                      traces write 0.0 — no timing was observed.
optional
    compile     bool  first call at this (op, shape signature): wall_s
                      includes the one-time start-up (kernel library
                      load, allocator growth; "compile-vs-steady" flag)
    tenants     int   session slots in the dispatch
    ticks       int   ticks advanced (observe_many chunk length)
    capacity    int   per-session padded capacity
    cap_bucket  int   next_pow2(capacity) — the retrace bucket
    engine      str   "classification" | "regression" | "registry"
    dispatch_s  float device-synchronized time, when the caller timed a
                      ``block_until_ready`` explicitly (the engines set
                      it under ``sync_timing=True``)
optional, schema v2 (replay/loadgen)
    workload    str   synthetic-trace generator kind (telemetry.loadgen)
    active      list  tenant slots active on this tick (ints); absent
                      means all ``tenants`` slots are active
    slo_s       float per-op latency objective; replay counts a
                      violation when sojourn (completion - arrival)
                      exceeds it
    seed        int   generator seed (synthetic traces)
optional, schema v3 (fault schedule — robustness.faults)
    fault       dict  the fault stamped onto this record by the chaos
                      harness: ``{"kind": <fault kind>, ...}`` —
                      traffic value faults add ``tenant``;
                      ``duplicate_arrival`` adds ``of_seq`` (the seq of
                      the earlier observe this record re-delivers).
                      Replay honors it (corrupts the tick's inputs /
                      dedups); fault-unaware readers ignore it. v2
                      files (no fault fields) validate unchanged.
    delay_s     float injected dispatch delay: replay treats arrival as
                      ``t + delay_s``
    extra: any remaining keys are recorder-specific (e.g. drained device
    counters on a flush record) and must be JSON-serializable.

``Tracer(path, annotate=True)`` additionally wraps each recorded op in a
``torch.profiler.record_function("repro.<op>")`` range, so records line up
with device traces captured by ``torch.profiler.profile``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, IO

import torch

SCHEMA_VERSION = 3

OP_KINDS = (
    "observe", "observe_many", "predict", "intervals", "pvalues",
    "evict", "grow", "snapshot_save", "snapshot_restore", "fit",
)

_REQUIRED = {"schema": int, "seq": int, "t": float, "op": str,
             "wall_s": float}
_OPTIONAL = {"compile": bool, "tenants": int, "ticks": int,
             "capacity": int, "cap_bucket": int, "engine": str,
             "dispatch_s": float,
             # v2 (replay/loadgen) fields — all optional, so v1 readers
             # that ignore unknown keys keep working and v1 files
             # validate unchanged
             "workload": str, "active": list, "slo_s": float,
             "seed": int,
             # v3 (fault schedule) fields — same optional-only rule, so
             # v2 files validate unchanged
             "fault": dict, "delay_s": float}

TRACE_SCHEMA = {"version": SCHEMA_VERSION, "required": _REQUIRED,
                "optional": _OPTIONAL, "op_kinds": OP_KINDS}


def capacity_bucket(capacity: int) -> int:
    """The engine retrace bucket: smallest power of two >= capacity."""
    return 1 << max(int(capacity) - 1, 0).bit_length()


def validate_record(rec: dict[str, Any]) -> None:
    """Raise ValueError if ``rec`` does not satisfy TRACE_SCHEMA."""
    for k, ty in _REQUIRED.items():
        if k not in rec:
            raise ValueError(f"trace record missing required field {k!r}: "
                             f"{rec}")
        v = rec[k]
        ok = isinstance(v, ty) or (ty is float and isinstance(v, int)
                                   and not isinstance(v, bool))
        if not ok or (ty is int and isinstance(v, bool)):
            raise ValueError(
                f"trace field {k!r} has type {type(v).__name__}, "
                f"expected {ty.__name__}: {rec}")
    if not 1 <= rec["schema"] <= SCHEMA_VERSION:
        raise ValueError(f"trace schema {rec['schema']} not in "
                         f"1..{SCHEMA_VERSION}")
    if rec["op"] not in OP_KINDS:
        raise ValueError(f"unknown trace op {rec['op']!r} "
                         f"(known: {OP_KINDS})")
    for k, ty in _OPTIONAL.items():
        if k in rec:
            v = rec[k]
            ok = isinstance(v, ty) or (ty is float and isinstance(v, int)
                                       and not isinstance(v, bool))
            if not ok or (ty is int and isinstance(v, bool)):
                raise ValueError(
                    f"trace field {k!r} has type {type(v).__name__}, "
                    f"expected {ty.__name__}: {rec}")
    if "active" in rec and not all(
            isinstance(s, int) and not isinstance(s, bool) and s >= 0
            for s in rec["active"]):
        raise ValueError(f"trace field 'active' must hold non-negative "
                         f"tenant indices: {rec['active']}")
    if "fault" in rec and not isinstance(rec["fault"].get("kind"), str):
        # lenient on purpose (no robustness import): the kind must be a
        # string; harness-specific fields ride along untyped
        raise ValueError(f"trace field 'fault' must carry a string "
                         f"'kind': {rec['fault']}")


def iter_trace(path: str, *, validate: bool = True):
    """Stream a JSONL trace file one record at a time.

    A generator, so replaying a multi-GB trace never loads the whole
    file into memory. ``validate=True`` (default) applies the same
    per-record schema check as ``validate_trace_file`` plus the seq
    monotonicity invariant; ``validate=False`` is the raw parse.
    """
    seq = -1
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if validate:
                validate_record(rec)
                if rec["seq"] <= seq:
                    raise ValueError(
                        f"trace seq not monotone at {rec['seq']}")
                seq = rec["seq"]
            yield rec


def read_trace(path: str) -> list[dict[str, Any]]:
    """Load a JSONL trace file (no validation; see validate_trace_file)."""
    return list(iter_trace(path, validate=False))


def validate_trace_file(path: str) -> list[dict[str, Any]]:
    """Read + schema-validate every record; returns the records."""
    return list(iter_trace(path, validate=True))


def write_trace(path_or_file: str | IO[str],
                records: "list[dict[str, Any]]") -> int:
    """Write pre-built records (e.g. a loadgen trace) as JSONL.

    Unlike ``Tracer.record`` the records' ``t``/``seq`` are taken as
    given — synthetic traces carry *arrival* times, not recording
    times. Every record is schema-validated; returns the record count.
    """
    seq = -1
    f: IO[str]
    if isinstance(path_or_file, str):
        d = os.path.dirname(path_or_file)
        if d:
            os.makedirs(d, exist_ok=True)
        f = open(path_or_file, "w")
        owns = True
    else:
        f, owns = path_or_file, False
    try:
        n = 0
        for rec in records:
            validate_record(rec)
            if rec["seq"] <= seq:
                raise ValueError(f"trace seq not monotone at {rec['seq']}")
            seq = rec["seq"]
            f.write(json.dumps(rec) + "\n")
            n += 1
        return n
    finally:
        if owns:
            f.close()


class Tracer:
    """Append-only JSONL trace writer.

    Records are flushed per line (the file is valid mid-run; a crash
    loses at most the current line). ``annotate=True`` wraps ``op()``
    bodies in ``torch.profiler.record_function("repro.<op>")`` so host
    records can be joined against a profiler trace of the same run.
    """

    def __init__(self, path_or_file: str | IO[str], *,
                 annotate: bool = False):
        if isinstance(path_or_file, str):
            d = os.path.dirname(path_or_file)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f: IO[str] = open(path_or_file, "w")
            self._owns = True
            self.path: str | None = path_or_file
        else:
            self._f = path_or_file
            self._owns = False
            self.path = getattr(path_or_file, "name", None)
        self.annotate = annotate
        self._t0 = time.perf_counter()
        self._seq = 0
        self._seen: set = set()
        self._closed = False

    # -- compile-vs-steady ---------------------------------------------------

    def first_call(self, op: str, signature: Any = None) -> bool:
        """True exactly once per (op, signature): the compile call."""
        key = (op, signature)
        if key in self._seen:
            return False
        self._seen.add(key)
        return True

    # -- recording -----------------------------------------------------------

    def record(self, op: str, wall_s: float, **fields) -> dict[str, Any]:
        if self._closed:
            return {}
        rec: dict[str, Any] = {
            "schema": SCHEMA_VERSION,
            "seq": self._seq,
            "t": time.perf_counter() - self._t0,
            "op": op,
            "wall_s": float(wall_s),
        }
        for k, v in fields.items():
            if v is None:
                continue
            if k == "capacity":
                rec["capacity"] = int(v)
                rec["cap_bucket"] = capacity_bucket(int(v))
                continue
            if k in ("tenants", "ticks", "cap_bucket"):
                v = int(v)
            elif k in ("dispatch_s",):
                v = float(v)
            elif k == "compile":
                v = bool(v)
            rec[k] = v
        validate_record(rec)
        self._seq += 1
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        return rec

    def op(self, op: str, *, signature: Any = None, **fields):
        """Context manager: times the body and records one line.

        ``signature`` feeds the compile-vs-steady flag (first call at a
        given (op, signature) is the compiling one). Extra ``fields``
        land in the record. The open record dict is yielded so the body
        can attach late fields (e.g. ``dispatch_s``).
        """
        return _OpContext(self, op, signature, fields)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _OpContext:
    def __init__(self, tracer: Tracer, op: str, signature, fields):
        self._tracer = tracer
        self._op = op
        self._sig = signature
        self._fields = dict(fields)
        self._ann = None
        self.late: dict[str, Any] = {}

    def __enter__(self):
        self._fields.setdefault(
            "compile", self._tracer.first_call(self._op, self._sig))
        if self._tracer.annotate:
            self._ann = torch.profiler.record_function(f"repro.{self._op}")
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self._t0
        if self._ann is not None:
            self._ann.__exit__(*exc)
        if exc[0] is None:
            self._tracer.record(self._op, wall,
                                **{**self._fields, **self.late})
        return False


__all__ = ["SCHEMA_VERSION", "OP_KINDS", "TRACE_SCHEMA", "Tracer",
           "capacity_bucket", "validate_record", "iter_trace",
           "read_trace", "validate_trace_file", "write_trace"]
