"""Per-engine instrumentation, counterpart of ``repro/telemetry/hooks.py``.

``EngineTelemetry`` times each engine-level operation (observe,
observe_many, predict, intervals, pvalues, grow) into a latency
histogram under the JAX package's names (``engine_<op>_wall_s``, and
``engine_<op>_compile_s`` for the first call at a shape signature),
counts it in ``engine_ops_total{op,engine}``, writes one trace record a
call when a ``Tracer`` is attached, and carries the device tick stats
(``.ticks``, ``telemetry.device``; ``record_chunk`` before a chunk).

The wall time is host time around the launches: CUDA launches are
asynchronous, so by default it is the enqueue time, as the JAX
package's dispatch time is. ``sync=True`` makes it device-true: the
engines pass each operation's output through the yielded handle's
``sync()``, which synchronises the current stream inside the timed
region and stamps the record's ``dispatch_s``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

import torch

from repro_torch.telemetry.device import TickStats
from repro_torch.telemetry.metrics import MetricsRegistry, get_registry
from repro_torch.telemetry.tracer import Tracer


class _TimedHandle:
    """Yielded by ``EngineTelemetry.timed``; carries late record fields.

    ``sync(value)`` passes ``value`` through; with ``sync=True`` it first
    synchronises the current CUDA stream (when ``value`` is on a card)
    and stamps ``dispatch_s``.
    """

    __slots__ = ("_sync", "_t0", "late")

    def __init__(self, sync_enabled: bool, t0: float):
        self._sync = sync_enabled
        self._t0 = t0
        self.late: dict[str, Any] = {}

    def sync(self, value):
        if self._sync:
            if isinstance(value, torch.Tensor) and value.is_cuda:
                torch.cuda.current_stream(value.device).synchronize()
            self.late["dispatch_s"] = time.perf_counter() - self._t0
        return value


class EngineTelemetry:
    """Instrumentation state attached to one serving engine. Without the
    state accessors (``n_of`` / ``head_of`` / ``wrap_of``) it times
    operations only (the registry serving loop)."""

    def __init__(self, *, engine: str, n_of: Callable | None = None,
                 head_of: Callable | None = None,
                 wrap_of: Callable | None = None,
                 metrics: MetricsRegistry | None = None,
                 tracer: Tracer | None = None, sync: bool = False):
        self.engine = engine
        self.metrics = metrics if metrics is not None else get_registry()
        self.tracer = tracer
        self.sync = sync
        self._accessors = (n_of, head_of, wrap_of)
        self.ticks = (TickStats(self.metrics, engine=engine)
                      if n_of is not None else None)
        self._seen: set = set()

    def first_call(self, op: str, signature: Any) -> bool:
        key = (op, signature)
        if key in self._seen:
            return False
        self._seen.add(key)
        return True

    def record_op(self, op: str, wall_s: float, *, compile_flag: bool,
                  ticks: int | None = None, tenants: int | None = None,
                  capacity: int | None = None,
                  dispatch_s: float | None = None) -> None:
        m = self.metrics
        m.counter("engine_ops_total", op=op, engine=self.engine).inc()
        suffix = "compile_s" if compile_flag else "wall_s"
        m.histogram(f"engine_{op}_{suffix}", engine=self.engine).observe(
            wall_s)
        if self.tracer is not None:
            self.tracer.record(op, wall_s, compile=compile_flag,
                               ticks=ticks, tenants=tenants,
                               capacity=capacity, engine=self.engine,
                               dispatch_s=dispatch_s)

    @contextlib.contextmanager
    def timed(self, op: str, *, signature: Any = None,
              ticks: int | None = None, tenants: int | None = None,
              capacity: int | None = None):
        """Time one engine operation (no synchronisation unless built
        with ``sync=True`` and the output goes through ``sync()``)."""
        compile_flag = self.first_call(op, signature)
        ann = contextlib.nullcontext()
        if self.tracer is not None and self.tracer.annotate:
            ann = torch.profiler.record_function(f"repro.{op}")
        with ann:
            t0 = time.perf_counter()
            handle = _TimedHandle(self.sync, t0)
            yield handle
            wall = time.perf_counter() - t0
        self.record_op(op, wall, compile_flag=compile_flag, ticks=ticks,
                       tenants=tenants, capacity=capacity,
                       dispatch_s=handle.late.get("dispatch_s"))

    def record_chunk(self, state, window: int, actives) -> None:
        """Copy the pre-chunk ``n``/``head``/``wrap`` of ``state`` and the
        ``(T, S)`` active mask on the device (two launches) for the tick
        stats. Call before the chunk's first tick."""
        pre = torch.stack([f(state) for f in self._accessors])
        self.ticks.record(pre, window, actives.clone())

    def drain(self) -> dict[str, int]:
        """Publish the accumulated device tick stats (one host sync)."""
        return self.ticks.drain() if self.ticks is not None else {}


__all__ = ["EngineTelemetry", "_TimedHandle"]
