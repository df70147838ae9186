"""Online validity monitors: the CP correctness signals, as metrics.
A copy of ``repro/telemetry/validity.py`` (numpy only), so the port
imports nothing of ``repro``.

Under exchangeability, online conformal prediction guarantees two
observable invariants (Vovk et al.; Zeni et al., "Conformal Prediction:
a Unified Review"): the smoothed p-value of the *observed* label is
uniform on [0, 1], and consequently the eps-level prediction set covers
the observed label with probability 1 - eps. The test suite asserts
both offline; these monitors track them *in serving*, per tenant, over
a rolling window, so drift/miscoverage is a dashboard line instead of a
post-mortem:

* ``CoverageMonitor``   — rolling empirical coverage vs the 1 - eps
  target: the observed label is in the eps-level set iff its smoothed
  p-value exceeds eps.
* ``UniformityMonitor`` — rolling two-sided Kolmogorov-Smirnov distance
  sup_u |ECDF(u) - u| of the p-value stream, vectorized across tenants
  (large KS at stable coverage = the sets are mis-sized, not just
  mis-centered).
* ``DriftMonitor``      — the simple-mixture exchangeability martingale
  (``core.online.simple_mixture_log_martingale``) maintained
  *incrementally* per tenant: log M grows past the threshold only under
  non-exchangeable traffic (valid by Ville's inequality).

All monitors are host-side numpy over the p-values the engines already
return — they add nothing to the device graph. NaN p-values (inactive
lanes / warmup) are skipped per tenant, so tenants advance on their own
clocks. ``export(metrics)`` publishes aggregate gauges; per-tenant
series are available from the arrays directly.
"""
from __future__ import annotations

import math

import numpy as np

_EPS_GRID = np.linspace(0.05, 0.95, 19)  # == simple_mixture_log_martingale
_P_FLOOR = 1e-12


class _RollingBuffer:
    """Per-tenant rolling window over an unevenly advancing stream."""

    def __init__(self, n_tenants: int, window: int):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.n_tenants = n_tenants
        self.window = window
        self.buf = np.full((n_tenants, window), np.nan)
        self.count = np.zeros(n_tenants, dtype=np.int64)  # total stored

    def push(self, values: np.ndarray) -> None:
        """Store ``values[s]`` for every tenant where it is finite."""
        v = np.asarray(values, dtype=float).reshape(-1)
        if v.shape[0] != self.n_tenants:
            raise ValueError(
                f"got {v.shape[0]} values for {self.n_tenants} tenants")
        valid = np.isfinite(v)
        idx = self.count[valid] % self.window
        self.buf[np.flatnonzero(valid), idx] = v[valid]
        self.count[valid] += 1

    def filled(self) -> np.ndarray:
        """(S,) number of live entries per tenant."""
        return np.minimum(self.count, self.window)


class CoverageMonitor:
    """Rolling empirical coverage of the eps-level prediction set.

    ``update`` takes one tick's per-tenant observed-label smoothed
    p-values ((S,) — or a (T, S) block); coverage counts ``p > eps``.
    ``coverage()`` is exactly the mean of the last ``window`` stored
    indicators per tenant (bitwise the same as an offline recomputation
    over the kept suffix — tested).
    """

    def __init__(self, epsilon: float, n_tenants: int, *,
                 window: int = 256):
        if not 0.0 < epsilon < 1.0:
            raise ValueError(f"epsilon {epsilon} outside (0, 1)")
        self.epsilon = float(epsilon)
        self.target = 1.0 - float(epsilon)
        self._buf = _RollingBuffer(n_tenants, window)

    def update(self, pvals) -> None:
        p = np.asarray(pvals, dtype=float)
        if p.ndim == 2:
            for row in p:
                self._buf.push(row)
        else:
            self._buf.push(p)

    def counts(self) -> np.ndarray:
        return self._buf.filled()

    def coverage(self) -> np.ndarray:
        """(S,) rolling empirical coverage; NaN before any observation."""
        m = self._buf.filled()
        hits = np.nansum(self._buf.buf > self.epsilon, axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = hits / m
        return np.where(m > 0, out, np.nan)

    def export(self, metrics, *, engine: str = "classification") -> None:
        cov = self.coverage()
        seen = cov[np.isfinite(cov)]
        g = lambda name: metrics.gauge(name, engine=engine)  # noqa: E731
        g("validity_coverage_target").set(self.target)
        if seen.size:
            g("validity_coverage_mean").set(float(seen.mean()))
            g("validity_coverage_min").set(float(seen.min()))
            # binomial 3-sigma tolerance at the rolling window size: a
            # tenant below it is miscovering beyond sampling noise
            w = max(int(self._buf.filled().max()), 1)
            tol = 3.0 * math.sqrt(self.target * self.epsilon / w)
            g("validity_coverage_tolerance").set(tol)
            g("validity_tenants_below_target").set(
                int((seen < self.target - tol).sum()))


class UniformityMonitor:
    """Rolling KS distance of the p-value stream from Uniform[0, 1]."""

    def __init__(self, n_tenants: int, *, window: int = 256):
        self._buf = _RollingBuffer(n_tenants, window)

    def update(self, pvals) -> None:
        p = np.asarray(pvals, dtype=float)
        if p.ndim == 2:
            for row in p:
                self._buf.push(row)
        else:
            self._buf.push(p)

    def ks(self) -> np.ndarray:
        """(S,) sup_u |ECDF(u) - u| per tenant; NaN when empty."""
        m = self._buf.filled().astype(float)
        u = np.sort(self._buf.buf, axis=1)  # NaNs sort to the end
        i = np.arange(self._buf.window, dtype=float)[None, :]
        live = i < m[:, None]
        with np.errstate(invalid="ignore", divide="ignore"):
            d_plus = (i + 1.0) / m[:, None] - u
            d_minus = u - i / m[:, None]
        d = np.maximum(np.where(live, d_plus, -np.inf),
                       np.where(live, d_minus, -np.inf)).max(axis=1)
        return np.where(m > 0, d, np.nan)

    def export(self, metrics, *, engine: str = "classification") -> None:
        ks = self.ks()
        seen = ks[np.isfinite(ks)]
        if seen.size:
            metrics.gauge("validity_ks_max", engine=engine).set(
                float(seen.max()))
            metrics.gauge("validity_ks_mean", engine=engine).set(
                float(seen.mean()))


class DriftMonitor:
    """Per-tenant simple-mixture exchangeability martingale, incremental.

    Maintains the per-epsilon log power-martingale sums so each tick is
    an O(S * E) vector add; ``log_m()`` equals
    ``core.online.simple_mixture_log_martingale`` evaluated on the full
    per-tenant p-value history (same mixture grid; float64 here vs the
    device's float32 — equal to numerical tolerance, tested).
    ``flagged()`` applies the Ville threshold to the *running max* of
    log M, the read-out that also catches fast-re-conforming measures.
    """

    def __init__(self, n_tenants: int, *, threshold: float = 2.0):
        self.n_tenants = n_tenants
        self.threshold = float(threshold)
        self._logm = np.zeros((n_tenants, _EPS_GRID.size))
        self.max_log_m = np.full(n_tenants, -np.inf)
        self.ticks = np.zeros(n_tenants, dtype=np.int64)

    def update(self, pvals) -> None:
        p = np.asarray(pvals, dtype=float)
        if p.ndim == 2:
            for row in p:
                self.update(row)
            return
        valid = np.isfinite(p)
        if not valid.any():
            return
        lp = np.log(np.maximum(p[valid], _P_FLOOR))
        inc = np.log(_EPS_GRID)[None, :] + lp[:, None] * (_EPS_GRID - 1.0)
        self._logm[valid] += inc
        self.ticks[valid] += 1
        lm = self._mix(self._logm[valid])
        self.max_log_m[valid] = np.maximum(self.max_log_m[valid], lm)

    @staticmethod
    def _mix(logm_rows: np.ndarray) -> np.ndarray:
        mx = logm_rows.max(axis=1, keepdims=True)
        return (mx[:, 0] + np.log(np.exp(logm_rows - mx).sum(axis=1))
                - np.log(_EPS_GRID.size))

    def log_m(self) -> np.ndarray:
        """(S,) current log mixture martingale (0 before any tick)."""
        out = self._mix(self._logm)
        return np.where(self.ticks > 0, out, 0.0)

    def flagged(self, *, use_max: bool = True) -> np.ndarray:
        stat = self.max_log_m if use_max else self.log_m()
        return stat > self.threshold

    def export(self, metrics, *, engine: str = "classification",
               use_max: bool = True) -> None:
        lm = self.log_m()
        mx = (float(np.max(self.max_log_m)) if (self.ticks > 0).any()
              else 0.0)
        metrics.gauge("drift_log_m_max", engine=engine).set(mx)
        metrics.gauge("drift_log_m_mean", engine=engine).set(
            float(np.mean(lm)))
        metrics.gauge("drift_threshold", engine=engine).set(self.threshold)
        metrics.gauge("drift_tenants_flagged", engine=engine).set(
            int(self.flagged(use_max=use_max).sum()))


__all__ = ["CoverageMonitor", "UniformityMonitor", "DriftMonitor"]
