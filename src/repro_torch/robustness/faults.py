"""Deterministic keyed fault injection for the serving stack, counterpart
of ``repro/robustness/faults.py`` (numpy and the standard library only,
kept as a copy so the port imports nothing of ``repro``).

Every injected fault is a pure function of ``(seed, site, step)``
(``_key_rng``), so a failing chaos run replays bit for bit from its
seed, and the same seed gives the same plan in both packages. A
``FaultPlan`` is a static schedule of ``Fault``s; a ``FaultInjector``
applies its I/O and timing faults at the named sites of
``checkpoint.store.CheckpointStore``; the traffic kinds are applied to
traffic arrays by ``corrupt_traffic``.

Fault kinds
-----------
I/O (``IO_FAULTS``, at store sites):
    write_fail     the attempt raises ``TransientWriteError`` (an
                   ``OSError``, the saver's retry class) for the first
                   ``times`` attempts at that (site, step); ``times < 0``
                   raises ``PermanentWriteError`` forever.
    partial_write  the written file is truncated to half its size after
                   its checksum was recorded (a torn write).
    corrupt_shard  one byte of the written file is flipped after
                   checksumming (silent disk corruption).
    checksum_flip  the digest recorded in the manifest is perturbed.
traffic (``TRAFFIC_FAULTS``, on observe inputs):
    nan_feature / inf_feature    a feature coordinate becomes NaN / Inf
    label_out_of_range           classification: label >= n_labels;
                                 regression: label becomes Inf
    tau_out_of_range             tie-break tau outside [0, 1]
    duplicate_arrival            an earlier event id delivered again
timing (``TIMING_FAULTS``):
    delay          sleep ``param`` seconds at an I/O site
state (``STATE_FAULTS``, test harness only):
    state_poison   a NaN written straight into one lane's state
                   (``poison_state``), which admission cannot see.

Sites (``SITES``): ``store.write``, ``store.shard``, ``store.manifest``,
``store.commit`` (just before the COMMITTED marker), ``traffic``,
``state``.
"""
from __future__ import annotations

import os
import time
import zlib
from dataclasses import dataclass

import numpy as np

IO_FAULTS = ("write_fail", "partial_write", "corrupt_shard",
             "checksum_flip")
TRAFFIC_FAULTS = ("nan_feature", "inf_feature", "label_out_of_range",
                  "tau_out_of_range", "duplicate_arrival")
TIMING_FAULTS = ("delay",)
STATE_FAULTS = ("state_poison",)
FAULT_KINDS = IO_FAULTS + TRAFFIC_FAULTS + TIMING_FAULTS + STATE_FAULTS

#: traffic kinds that corrupt observe *values* (the guard's admission
#: check rejects exactly these); duplicate_arrival is a delivery fault,
#: which a trace replay deduplicates
VALUE_FAULTS = ("nan_feature", "inf_feature", "label_out_of_range",
                "tau_out_of_range")

SITES = ("store.write", "store.shard", "store.manifest", "store.commit",
         "traffic", "state")


class TransientWriteError(OSError):
    """An injected write failure the saver is expected to retry."""


class PermanentWriteError(RuntimeError):
    """An injected write failure that must be surfaced, never retried."""


def _key_rng(seed: int, site: str, step: int) -> np.random.Generator:
    """The keyed generator: one independent stream per (seed, site,
    step) — the determinism contract of the whole module."""
    return np.random.default_rng(
        (int(seed), zlib.crc32(site.encode("utf-8")), int(step)))


@dataclass(frozen=True)
class Fault:
    """One scheduled fault at ``(site, step)``.

    ``tenant`` scopes traffic/state faults to one lane; ``param`` is
    the delay in seconds (timing) or unused; ``times`` bounds how many
    attempts an I/O fault fires for (``write_fail``: attempts 1..times
    raise, later retries succeed; negative = permanent).
    """

    site: str
    step: int
    kind: str
    tenant: int = -1
    param: float = 0.0
    times: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(known: {FAULT_KINDS})")


class FaultPlan:
    """A static, keyed schedule of faults.

    Either built from an explicit ``faults`` list or drawn by
    ``FaultPlan.random`` — in both cases ``at(site, step)`` is the
    lookup every injection point uses. ``random`` keys each
    (site, step) cell independently via ``(seed, site, step)``, so the
    fault decision at one step never depends on how many steps the
    plan covers (tested).
    """

    def __init__(self, seed: int, faults=()):
        self.seed = int(seed)
        self._by: dict = {}
        for f in faults:
            self._by.setdefault((f.site, f.step), []).append(f)

    def at(self, site: str, step: int) -> tuple:
        return tuple(self._by.get((site, int(step)), ()))

    def faults(self) -> list:
        out = [f for fs in self._by.values() for f in fs]
        return sorted(out, key=lambda f: (f.site, f.step, f.kind))

    def __len__(self) -> int:
        return sum(len(fs) for fs in self._by.values())

    @classmethod
    def random(cls, seed: int, *, steps: int, tenants: int = 1,
               rate: float = 0.02, kinds=VALUE_FAULTS,
               sites=("traffic",), param: float = 0.0,
               times: int = 1) -> "FaultPlan":
        """Draw a keyed random plan: each (site, step) independently
        carries one fault with probability ``rate``, kind and tenant
        drawn from the same keyed stream."""
        kinds = tuple(kinds)
        faults = []
        for site in sites:
            for step in range(int(steps)):
                rng = _key_rng(seed, site, step)
                if rng.random() >= rate:
                    continue
                kind = kinds[int(rng.integers(len(kinds)))]
                tenant = int(rng.integers(max(tenants, 1)))
                faults.append(Fault(site, step, kind, tenant=tenant,
                                    param=param, times=times))
        return cls(seed, faults)


def flip_byte(path: str, *, offset: int | None = None,
              seed: int = 0) -> int:
    """Flip one byte of ``path`` in place (offset keyed by ``seed``
    when not given); returns the offset. The unit-test primitive for
    'plant a flipped byte' and the ``corrupt_shard`` implementation."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot flip a byte of empty file {path}")
    if offset is None:
        offset = int(_key_rng(seed, path and "flip", 0).integers(size))
    with open(path, "r+b") as fh:
        fh.seek(offset)
        b = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([b[0] ^ 0xFF]))
    return offset


class FaultInjector:
    """Applies a plan's I/O + timing faults at named injection sites.

    The store calls ``enter(site, step)`` at the start of an attempt
    (raises ``write_fail``, sleeps ``delay``), ``mutate_file`` after a
    file is written AND checksummed (silent corruption), and
    ``mutate_digest`` on the digest recorded in the manifest
    (``checksum_flip``). Attempt counts per (site, step) make
    transient ``write_fail`` faults clear after ``times`` attempts —
    the saver's retry loop is what survives them.
    """

    def __init__(self, plan: FaultPlan, *, metrics=None):
        self.plan = plan
        self._metrics = metrics
        self._attempts: dict = {}

    def _count(self, fault: Fault) -> None:
        if self._metrics is not None:
            self._metrics.counter("faults_injected_total",
                                  site=fault.site, kind=fault.kind).inc()

    def enter(self, site: str, step: int) -> None:
        key = (site, int(step))
        n = self._attempts.get(key, 0) + 1
        self._attempts[key] = n
        for f in self.plan.at(site, step):
            if f.kind == "delay" and n <= max(f.times, 1):
                self._count(f)
                time.sleep(f.param)
            elif f.kind == "write_fail":
                if f.times < 0:
                    self._count(f)
                    raise PermanentWriteError(
                        f"injected permanent write failure at {site} "
                        f"step {step}")
                if n <= f.times:
                    self._count(f)
                    raise TransientWriteError(
                        f"injected write failure (attempt {n}/{f.times})"
                        f" at {site} step {step}")

    def mutate_file(self, site: str, step: int, path: str) -> None:
        for f in self.plan.at(site, step):
            if f.kind == "partial_write":
                self._count(f)
                size = os.path.getsize(path)
                with open(path, "r+b") as fh:
                    fh.truncate(max(size // 2, 1))
            elif f.kind == "corrupt_shard":
                self._count(f)
                flip_byte(path, seed=self.plan.seed + step)

    def mutate_digest(self, site: str, step: int, digest: str) -> str:
        for f in self.plan.at(site, step):
            if f.kind == "checksum_flip":
                self._count(f)
                rng = _key_rng(self.plan.seed, site, step)
                i = int(rng.integers(len(digest)))
                digest = (digest[:i]
                          + format((int(digest[i], 16) + 1) % 16, "x")
                          + digest[i + 1:])
        return digest


def backoff_schedule(seed: int, step: int, retries: int,
                     base_s: float) -> list:
    """Keyed deterministic exponential backoff: delay_i = base * 2^i *
    (1 + U(0, 0.25)) with U drawn from rng((seed, step, attempt)) —
    the same (seed, step) always waits the same schedule."""
    return [
        float(base_s * (2.0 ** i)
              * (1.0 + np.random.default_rng(
                  (int(seed), int(step), i)).uniform(0.0, 0.25)))
        for i in range(int(retries))]


def poisoned_values(kind: str, *, mode: str, n_labels: int = 2):
    """Replacement (x, y, tau) values for a traffic value fault; a
    ``None`` slot is left unchanged."""
    if kind == "nan_feature":
        return (float("nan"), None, None)
    if kind == "inf_feature":
        return (float("inf"), None, None)
    if kind == "label_out_of_range":
        if mode == "classification":
            return (None, int(n_labels) + 7, None)
        return (None, float("inf"), None)
    if kind == "tau_out_of_range":
        return (None, None, 2.0)
    raise ValueError(f"{kind!r} is not a traffic value fault "
                     f"(known: {VALUE_FAULTS})")


def corrupt_traffic(plan: FaultPlan, xs, ys, taus, *, mode: str,
                    n_labels: int = 2, time_axis: int = 0,
                    site: str = "traffic", t0: int = 0) -> set:
    """Apply the plan's traffic value faults to traffic arrays IN
    PLACE; returns the set of hit ``(step, tenant)`` positions (the
    oracle mask for bit-exactness tests).

    ``xs``/``ys``/``taus`` are numpy arrays with time on ``time_axis``
    and the tenant axis on the other — (T, S, dim)/(T, S), the port's
    launcher layout, or (S, T, dim)/(S, T) with ``time_axis=1``.
    """
    T = ys.shape[time_axis]
    S = ys.shape[1 - time_axis]

    def ix(t, s):
        return (t, s) if time_axis == 0 else (s, t)

    hits = set()
    for t in range(T):
        for f in plan.at(site, t0 + t):
            if f.kind not in VALUE_FAULTS:
                continue
            lane = int(f.tenant) % S
            xv, yv, tv = poisoned_values(f.kind, mode=mode,
                                         n_labels=n_labels)
            if xv is not None:
                xs[ix(t, lane) + (0,)] = xv
            if yv is not None:
                ys[ix(t, lane)] = yv
            if tv is not None:
                taus[ix(t, lane)] = tv
            hits.add((t0 + t, lane))
    return hits


def poison_state(state, lane: int, *, value: float = float("nan")):
    """Write ``value`` straight into one lane's feature leaf, in place
    (``X[lane, 0, 0]`` of a ``Session`` or a ``RegStreamState``): the
    in-memory corruption admission cannot catch, which the guard's poison
    detector must. Returns ``state``."""
    X = state.knn.X if hasattr(state, "knn") else state.X
    X[lane, 0, 0] = value
    return state


__all__ = ["IO_FAULTS", "TRAFFIC_FAULTS", "TIMING_FAULTS", "STATE_FAULTS",
           "VALUE_FAULTS", "FAULT_KINDS", "SITES", "Fault", "FaultPlan",
           "FaultInjector", "TransientWriteError", "PermanentWriteError",
           "flip_byte", "backoff_schedule", "poisoned_values",
           "corrupt_traffic", "poison_state"]
