"""Fitted per-(op, capacity-bucket) latency model, and the tuning APIs.
A copy of ``repro/telemetry/costmodel.py`` (standard library only), so the
port imports nothing of ``repro``; it fits the port's trace records.

The trace records (``telemetry.tracer``) carry everything a serving
cost model needs: op kind, capacity bucket (the retrace granularity),
chunk length (``ticks``), wall time, and the compile-vs-steady flag
that keeps compilation out of the steady-state fit.

Model: for each (op, cap_bucket) group of *steady* records,

    wall_s  ~=  a  +  b * ticks

by least squares — ``a`` is the fixed per-dispatch overhead (host
round-trip, buffer shuffling), ``b`` the marginal per-tick cost. Ops
without a ``ticks`` axis (predict / intervals / snapshot) degenerate to
``a = median(wall_s), b = 0``. The fit is tiny on purpose: two
parameters per group is enough to answer the two tuning questions the
serving stack hand-tunes today, and few enough to be identifiable from
a short trace.

``suggest_chunk(op, bucket, overhead_frac)`` inverts the model: the
amortized per-tick cost of a T-chunk is ``a/T + b``, so the smallest
chunk whose dispatch-overhead share is <= ``overhead_frac`` is

    T  >=  a * (1 - f) / (b * f).

``suggest_buckets(...)`` replaces the hand-picked power-of-two capacity
buckets: fit ``b(bucket) ~ c * bucket^alpha`` (log-log least squares
across fitted buckets), then space boundaries geometrically in *cost*
— each bucket's top-vs-bottom cost ratio <= ``cost_ratio`` — i.e. a
capacity growth factor of ``cost_ratio ** (1/alpha)``. Sub-linear cost
scaling (alpha < 1, the dispatch-bound regime) yields coarser buckets
(fewer retraces for the same padding waste); super-linear scaling
yields finer ones.

The model persists as JSON (``save``/``load``/``to_json``) and the
round-trip is bitwise: parameters are Python floats, which
``json`` serializes via shortest-round-trip repr.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Iterable

MODEL_VERSION = 1

# ops whose cost scales with a ticks axis (the chunked observe path)
_TICKED_OPS = ("observe", "observe_many")


def _fit_affine(ticks: list[float], walls: list[float]) -> tuple[float,
                                                                 float]:
    """Least-squares wall ~= a + b*ticks, clamped to a, b >= 0."""
    n = len(ticks)
    mt = sum(ticks) / n
    mw = sum(walls) / n
    sxx = sum((t - mt) ** 2 for t in ticks)
    if sxx == 0.0:  # a single chunk length observed: all cost marginal
        return 0.0, mw / mt if mt else mw
    sxy = sum((t - mt) * (w - mw) for t, w in zip(ticks, walls))
    b = max(sxy / sxx, 0.0)
    a = max(mw - b * mt, 0.0)
    return a, b


class CostModel:
    """Per-(engine, op, cap_bucket) affine latency model.

    ``entries`` maps (engine, op, cap_bucket) -> {"a", "b", "n"}:
    dispatch overhead seconds, marginal per-tick seconds, sample count.
    ``engine`` may be "" when the trace did not label one.
    """

    def __init__(self, entries: dict[tuple[str, str, int],
                                     dict[str, float]] | None = None,
                 meta: dict[str, Any] | None = None):
        self.entries = dict(entries or {})
        self.meta = dict(meta or {})

    # -- fitting -------------------------------------------------------------

    @classmethod
    def fit(cls, records: Iterable[dict[str, Any]],
            **meta: Any) -> "CostModel":
        """Fit from trace records (steady only; compile records and
        zero-wall synthetic records are excluded)."""
        groups: dict[tuple[str, str, int], list[tuple[float, float]]] = {}
        for rec in records:
            if rec.get("compile") or rec["wall_s"] <= 0.0:
                continue
            key = (rec.get("engine", ""), rec["op"],
                   int(rec.get("cap_bucket", 0)))
            wall = float(rec.get("dispatch_s") or rec["wall_s"])
            groups.setdefault(key, []).append(
                (float(rec.get("ticks", 1)), wall))
        entries = {}
        for key, samples in groups.items():
            ticks = [t for t, _ in samples]
            walls = [w for _, w in samples]
            if key[1] in _TICKED_OPS:
                a, b = _fit_affine(ticks, walls)
            else:
                a, b = sorted(walls)[len(walls) // 2], 0.0
            entries[key] = {"a": a, "b": b, "n": float(len(samples))}
        return cls(entries, meta)

    # -- lookup --------------------------------------------------------------

    def _entry(self, op: str, cap_bucket: int | None,
               engine: str | None) -> dict[str, float] | None:
        """Exact match first, then nearest bucket (log distance), then
        any engine with that op."""
        cands = [(e, o, c) for (e, o, c) in self.entries
                 if o == op and (engine is None or e == engine)]
        if not cands:
            cands = [(e, o, c) for (e, o, c) in self.entries if o == op]
        if not cands:
            return None
        if cap_bucket is None:
            return self.entries[max(cands, key=lambda k: k[2])]
        best = min(cands, key=lambda k: abs(
            math.log(max(k[2], 1)) - math.log(max(cap_bucket, 1))))
        return self.entries[best]

    def predict(self, op: str, *, ticks: int = 1,
                cap_bucket: int | None = None,
                engine: str | None = None) -> float:
        """Modeled wall seconds of one dispatch."""
        e = self._entry(op, cap_bucket, engine)
        if e is None:
            raise KeyError(f"no fitted entry for op {op!r}")
        return e["a"] + e["b"] * ticks

    # -- tuning --------------------------------------------------------------

    def suggest_chunk(self, op: str = "observe_many", *,
                      cap_bucket: int | None = None,
                      engine: str | None = None,
                      overhead_frac: float = 0.05,
                      max_chunk: int = 1024) -> int:
        """Smallest observe_many chunk whose per-tick dispatch-overhead
        share is <= ``overhead_frac`` under the fitted model.

        Replaces the hand-tuned serving constant (chunk=64 in the
        benches). Falls back to the plain-``observe`` fit when the
        trace never chunked, and to ``max_chunk`` when the marginal
        cost is unresolvable (b == 0: overhead is everything, so chunk
        as much as latency tolerates).
        """
        if not 0.0 < overhead_frac < 1.0:
            raise ValueError("overhead_frac must be in (0, 1)")
        e = self._entry(op, cap_bucket, engine)
        if e is None or (e["b"] == 0.0 and e["a"] == 0.0):
            e = self._entry("observe", cap_bucket, engine)
        if e is None:
            raise KeyError(f"no fitted entry for op {op!r} / 'observe'")
        a, b = e["a"], e["b"]
        if b <= 0.0:
            return max_chunk
        t = a * (1.0 - overhead_frac) / (b * overhead_frac)
        return int(min(max(math.ceil(t), 1), max_chunk))

    def fit_capacity_scaling(self, op: str = "observe_many", *,
                             engine: str | None = None) -> tuple[float,
                                                                 float]:
        """(c, alpha) of per-tick cost ~ c * bucket^alpha across fitted
        buckets (log-log LS). Falls back to alpha=1 (linear — the
        memory-traffic model of the O(cap) tick) with fewer than two
        distinct buckets."""
        pts = [(c, e["a"] + e["b"]) if e["b"] == 0.0 else (c, e["b"])
               for (eng, o, c), e in self.entries.items()
               if o == op and c > 0 and (engine is None or eng == engine)]
        pts = [(c, v) for c, v in pts if v > 0.0]
        if len({c for c, _ in pts}) < 2:
            if not pts:
                return 0.0, 1.0
            c0, v0 = pts[0]
            return v0 / c0, 1.0
        lx = [math.log(c) for c, _ in pts]
        ly = [math.log(v) for _, v in pts]
        n = len(pts)
        mx, my = sum(lx) / n, sum(ly) / n
        sxx = sum((x - mx) ** 2 for x in lx)
        sxy = sum((x - mx) * (y - my) for x, y in zip(lx, ly))
        alpha = sxy / sxx
        c = math.exp(my - alpha * mx)
        return c, alpha

    def suggest_buckets(self, *, cap_min: int, cap_max: int,
                        op: str = "observe_many",
                        engine: str | None = None,
                        cost_ratio: float = 2.0) -> list[int]:
        """Capacity-bucket boundaries spaced geometrically in *cost*.

        Each bucket's top-to-bottom modeled cost ratio is at most
        ``cost_ratio`` (2.0 reproduces the hand-tuned power-of-two
        scheme exactly when cost scales linearly with capacity). The
        boundaries are what the engine pool should retrace at; the last
        one always covers ``cap_max``.
        """
        if cap_min < 1 or cap_max < cap_min:
            raise ValueError(f"bad capacity range [{cap_min}, {cap_max}]")
        if cost_ratio <= 1.0:
            raise ValueError("cost_ratio must be > 1")
        _, alpha = self.fit_capacity_scaling(op, engine=engine)
        # clamp: a near-flat fit would put every capacity in one bucket
        # (growth factor -> inf) and a wildly super-linear one would
        # bucket per-capacity; both are fit noise at small trace sizes
        alpha = min(max(alpha, 0.25), 4.0)
        growth = cost_ratio ** (1.0 / alpha)
        growth = min(max(growth, 1.189), 16.0)  # >= 2**(1/4) per bucket
        bounds = [int(cap_min)]
        while bounds[-1] < cap_max:
            nxt = max(int(math.ceil(bounds[-1] * growth)), bounds[-1] + 1)
            bounds.append(min(nxt, int(cap_max)))
        return bounds

    # -- persistence ---------------------------------------------------------

    def to_json(self) -> dict[str, Any]:
        return {
            "version": MODEL_VERSION,
            "meta": self.meta,
            "entries": [
                {"engine": e, "op": o, "cap_bucket": c, **params}
                for (e, o, c), params in sorted(self.entries.items())
            ],
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "CostModel":
        if d.get("version") != MODEL_VERSION:
            raise ValueError(f"cost model version {d.get('version')} != "
                             f"{MODEL_VERSION}")
        entries = {}
        for e in d["entries"]:
            entries[(e["engine"], e["op"], int(e["cap_bucket"]))] = {
                "a": float(e["a"]), "b": float(e["b"]),
                "n": float(e["n"])}
        return cls(entries, d.get("meta"))

    def save(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "CostModel":
        with open(path) as f:
            return cls.from_json(json.load(f))


def fit_cost_model(records: Iterable[dict[str, Any]],
                   **meta: Any) -> CostModel:
    """Module-level alias for ``CostModel.fit``."""
    return CostModel.fit(records, **meta)


__all__ = ["MODEL_VERSION", "CostModel", "fit_cost_model"]
