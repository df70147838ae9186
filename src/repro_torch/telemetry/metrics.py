"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.
A copy of ``repro/telemetry/metrics.py`` (standard library only), so the
port imports nothing of ``repro``; metric names and exports are the same.

Deliberately tiny (no deps, no threads, no exposition server): serving
code increments in-process objects; ``to_text()`` renders a
prometheus-style plain-text snapshot and ``dump()`` writes the same
snapshot as JSON. Histograms use *fixed* bucket boundaries chosen at
construction, so ``observe`` is an O(log B) bisect and quantile
estimates (p50/p99) come from linear interpolation inside the bucket —
the standard fixed-bucket estimator, exact whenever a quantile lands on
a bucket boundary.

Metric identity is ``(name, sorted label items)``; the same name may
carry different label sets (e.g. ``ops_total{op="observe_many"}``).

    reg = MetricsRegistry()
    reg.counter("engine_ticks_total", op="observe_many").inc(64)
    reg.histogram("observe_many_wall_s").observe(0.0123)
    print(reg.to_text())
    reg.dump("metrics.json")

A process-wide default registry (``get_registry()``) backs callers that
don't thread an explicit one; tests swap it with ``set_registry`` or
pass fresh instances.
"""
from __future__ import annotations

import bisect
import json
import math
import threading
import time
from typing import Any, Iterable

# Default latency buckets (seconds): 1us .. ~100s, quarter-decade steps.
# Wide enough for a compile-included first dispatch and fine enough to
# resolve sub-ms steady-state ticks.
DEFAULT_LATENCY_BUCKETS = tuple(
    10.0 ** (e / 4.0) for e in range(-24, 9))  # 1e-6 .. 1e2


def _label_key(labels: dict[str, Any]) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus exposition-format label-value escaping: backslash,
    double quote and newline must be escaped (in that order — escaping
    the backslash first keeps the other escapes unambiguous)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Monotone counter. ``inc`` accepts any non-negative increment."""

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} decremented by {v}")
        self.value += float(v)

    def merge(self, other: "Counter") -> None:
        """Fold another shard's counter in: counts sum."""
        self.value += other.value


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = math.nan

    def set(self, v: float) -> None:
        self.value = float(v)

    def merge(self, other: "Gauge", policy: str = "max") -> None:
        """Fold another shard's gauge in. ``policy``: "max" (default —
        watermarks), "min", "sum" (additive occupancy), or "last"
        (other wins). An unset side (NaN) never clobbers a set one."""
        if math.isnan(other.value):
            return
        if math.isnan(self.value) or policy == "last":
            self.value = other.value
        elif policy == "max":
            self.value = max(self.value, other.value)
        elif policy == "min":
            self.value = min(self.value, other.value)
        elif policy == "sum":
            self.value += other.value
        else:
            raise ValueError(f"unknown gauge merge policy {policy!r}")


class Histogram:
    """Fixed-bucket histogram with count/sum and quantile estimation.

    ``bounds`` are the inclusive upper edges of the finite buckets; one
    implicit overflow bucket catches everything above the last edge.
    ``quantile(q)`` interpolates linearly within the bucket containing
    the q-th observation (overflow observations report the last finite
    edge — a lower bound, flagged by ``quantile_is_lower_bound``).
    """

    def __init__(self, name: str, labels: tuple,
                 bounds: Iterable[float] = DEFAULT_LATENCY_BUCKETS):
        self.name = name
        self.labels = labels
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket edge")
        self.counts = [0] * (len(self.bounds) + 1)  # +1: overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def merge(self, other: "Histogram") -> None:
        """Fold another shard's histogram in (bucket-wise adds).

        Both histograms must share bucket boundaries — the merged
        counts are then exactly the histogram of the union stream, so
        quantile estimates degrade no further than either input's.
        """
        if other.bounds != self.bounds:
            raise ValueError(
                f"histogram {self.name}: cannot merge mismatched bucket "
                f"boundaries ({len(self.bounds)} vs {len(other.bounds)} "
                "edges)")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def quantile(self, q: float) -> float:
        """Fixed-bucket quantile estimate of the q-th observation."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return math.nan
        rank = q * self.count  # observations at or below the answer
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= len(self.bounds):  # overflow bucket
                    return max(self.bounds[-1], self.min)
                lo = self.bounds[i - 1] if i > 0 else min(self.min, 0.0)
                hi = self.bounds[i]
                frac = (rank - cum) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                # the true observations bound the bucket estimate
                return min(max(est, self.min), self.max)
            cum += c
        return self.max  # q == 1 with trailing empties

    def quantile_is_lower_bound(self, q: float) -> bool:
        """True when ``quantile(q)`` fell in the overflow bucket."""
        if self.count == 0:
            return False
        rank = q * self.count
        return self.count - self.counts[-1] < rank and self.counts[-1] > 0

    def snapshot(self) -> dict[str, Any]:
        # ``empty`` makes the zero-observation edge explicit: every
        # quantile/min/max below is NaN by definition, not by accident,
        # and downstream consumers can branch on the flag instead of
        # NaN-sniffing.
        return {
            "count": self.count,
            "sum": self.sum,
            "empty": self.count == 0,
            "min": self.min if self.count else math.nan,
            "max": self.max if self.count else math.nan,
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Holds every metric of one process (or one test)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, Counter | Gauge | Histogram] = {}
        self.created_at = time.time()

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (cls.__name__, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, _label_key(labels), **kw)
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, *, bounds=DEFAULT_LATENCY_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def merge(self, other: "MetricsRegistry", *,
              gauge_policy: str = "max") -> "MetricsRegistry":
        """Fold another registry's metrics into this one (returns self).

        Counters sum, histograms add bucket-wise (matching boundaries
        required), gauges merge under ``gauge_policy`` ("max" default,
        or "min"/"sum"/"last"). Metric identity is (type, name,
        labels) — disjoint series are adopted wholesale, shared series
        merged value-wise. Identity: merging an empty registry is a
        no-op. Commutative up to gauge policy: with "max"/"min"/"sum",
        a.merge(b) and b.merge(a) agree on every counter, gauge, and
        histogram value (tested). This is the sharded-replay collection
        path: one registry per shard, merged into the report registry.
        """
        with other._lock:
            theirs = list(other._metrics.items())
        for key, m in theirs:
            cls = type(m)
            kw = {"bounds": m.bounds} if isinstance(m, Histogram) else {}
            mine = self._get(cls, m.name, dict(m.labels), **kw)
            if isinstance(m, Gauge):
                mine.merge(m, policy=gauge_policy)
            else:
                mine.merge(m)
        return self

    # -- export -------------------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        """JSON-serializable snapshot: one entry per metric."""
        out: list[dict[str, Any]] = []
        with self._lock:
            items = list(self._metrics.values())
        for m in sorted(items, key=lambda m: (m.name, m.labels)):
            entry: dict[str, Any] = {
                "name": m.name,
                "labels": dict(m.labels),
                "type": type(m).__name__.lower(),
            }
            if isinstance(m, Histogram):
                entry.update(m.snapshot())
            else:
                entry["value"] = m.value
            out.append(entry)
        return {"exported_at": time.time(), "metrics": out}

    def to_text(self) -> str:
        """Prometheus-flavored plain-text snapshot (one line per series;
        histograms render count/sum/p50/p99). The single human-readable
        formatting code path for every serving mode."""
        lines = []
        with self._lock:
            items = list(self._metrics.values())
        for m in sorted(items, key=lambda m: (m.name, m.labels)):
            ls = _label_str(m.labels)
            if isinstance(m, Histogram):
                s = m.snapshot()
                lines.append(
                    f"{m.name}{ls} count={s['count']} sum={s['sum']:.6g} "
                    f"p50={s['p50']:.6g} p99={s['p99']:.6g} "
                    f"max={s['max']:.6g}"
                    + (" empty=1" if s["empty"] else ""))
                # proper exposition series: rates (rate(name_count)) and
                # averages (name_sum / name_count) stay computable by
                # standard prometheus tooling, which cannot parse the
                # human-readable summary line above
                lines.append(f"{m.name}_count{ls} {s['count']}")
                lines.append(f"{m.name}_sum{ls} {s['sum']:.9g}")
            else:
                v = m.value
                vs = f"{v:.6g}" if isinstance(v, float) else str(v)
                lines.append(f"{m.name}{ls} {vs}")
        return "\n".join(lines)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


_global_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _global_registry


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (returns the previous one)."""
    global _global_registry
    prev = _global_registry
    _global_registry = reg
    return prev


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_LATENCY_BUCKETS", "get_registry", "set_registry"]
