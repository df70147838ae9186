"""Observability of the port's serving stack, counterpart of
``repro.telemetry`` (trace replay and load generation are not ported
yet):

* ``metrics``   — counters, gauges and fixed-bucket latency histograms
  with text and JSON export;
* ``tracer``    — the JSONL per-op trace, in the JAX package's schema;
* ``device``    — per-tick counters (evictions, ring wraps, occupancy)
  computed on the device in closed form and drained on demand;
* ``hooks``     — ``EngineTelemetry``, what an instrumented engine carries;
* ``validity``  — rolling coverage, p-value uniformity and drift
  martingales as metrics;
* ``costmodel`` — the per-(op, capacity-bucket) latency model fitted from
  trace records, behind the fleet's bucket bounds.

Instrumented engines are bitwise the plain ones: the tick stats read
only the integer bookkeeping leaves.
"""
from repro_torch.telemetry.costmodel import CostModel, fit_cost_model
from repro_torch.telemetry.device import TickStats, make_chunk_stats_fn
from repro_torch.telemetry.hooks import EngineTelemetry
from repro_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                           MetricsRegistry, get_registry,
                                           set_registry)
from repro_torch.telemetry.tracer import (OP_KINDS, SCHEMA_VERSION,
                                          TRACE_SCHEMA, Tracer,
                                          capacity_bucket, iter_trace,
                                          read_trace, validate_record,
                                          validate_trace_file, write_trace)
from repro_torch.telemetry.validity import (CoverageMonitor, DriftMonitor,
                                            UniformityMonitor)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "set_registry",
    "OP_KINDS", "SCHEMA_VERSION", "TRACE_SCHEMA", "Tracer",
    "capacity_bucket", "iter_trace", "read_trace", "validate_record",
    "validate_trace_file", "write_trace",
    "TickStats", "make_chunk_stats_fn", "EngineTelemetry",
    "CoverageMonitor", "DriftMonitor", "UniformityMonitor",
    "CostModel", "fit_cost_model",
]
