"""Device-side tick counters of the serving engines, counterpart of
``repro/telemetry/device.py``.

Every tick statistic is a closed form of the pre-chunk integer
bookkeeping leaves (``n``/``head``/``wrap``) and the chunk's ``(T, S)``
active mask: occupancy evolves as ``min(n0 + cumsum(active), window)``,
an eviction fires exactly on active ticks that start window-full, and
the ring head advances once per eviction, so a tenant's ring wraps are
``(head0 + evictions) // wrap - head0 // wrap``.

In eager PyTorch each of the closed form's ~25 small operations is a
launch, which on a one-tick ``observe`` costs as much host time as a
good part of the tick. So ``TickStats.record`` only copies a chunk's
pre-chunk ``n``/``head``/``wrap`` (one stack) and its active mask (one
clone) on the device, and ``flush`` computes the closed form for up to
``FLUSH_EVERY`` recorded chunks at once, batched over the chunks that
share a window and a length, and folds the result into a
device-resident accumulator. Nothing synchronises with the host but
``drain()``, which flushes first.

The port's ticks update ``n`` and ``head`` in place, so the engines
record a chunk before its first tick: the stream copies the pre-chunk
leaves. The stats read no float leaf, so an instrumented engine's
p-values and state are bitwise the plain engine's.

Stats (``STAT_KEYS``, each summed over tenants and ticks):

    ticks          active lanes
    evictions      active lanes at a full window (0 in grow mode)
    ring_wraps     evictions whose head pointer rolls over to slot 0
    backfills      eviction repairs run (== evictions: every ring
                   eviction repairs the k-NN lists in the same launch)
    occupancy_sum  post-tick live counts (mean = sum / ticks)
    occupancy_max  max post-tick live count (a max, not a sum)
"""
from __future__ import annotations

from typing import Callable

import torch

STAT_KEYS = ("ticks", "evictions", "ring_wraps", "backfills",
             "occupancy_sum", "occupancy_max")
_MAX_KEYS = ("occupancy_max",)
_MAX_MASK_IDX = tuple(STAT_KEYS.index(k) for k in _MAX_KEYS)


#: recorded chunks a ``TickStats`` holds before it computes their stats
FLUSH_EVERY = 64


def chunk_stats(n0, head0, wrap, window: int, actives) -> torch.Tensor:
    """The ``(len(STAT_KEYS),)`` int64 stat vector of a batch of ``C``
    chunks of one length ``T`` and one eviction ``window`` (an int; grow
    mode passes ``capacity + 1``): ``n0``, ``head0``, ``wrap (C, S)``
    the pre-chunk occupancy, ring head and modulus, ``actives (C, T,
    S)`` bool."""
    i64 = torch.int64
    n0, head0, wrap = (v.to(i64)[:, None] for v in (n0, head0, wrap))
    w = int(window)
    act = actives.to(i64)
    c = torch.cumsum(act, dim=1)  # arrivals up to and including t
    n_after = (n0 + c).clamp(max=w)
    n_pre = (n0 + c - act).clamp(max=w)
    ev = (actives & (n_pre >= w)).to(i64)
    ev_total = ev.sum(1, keepdim=True)  # (C, 1, S)
    wraps = ((head0 + ev_total) // wrap - head0 // wrap).sum()
    n_ev = ev.sum()
    return torch.stack([act.sum(), n_ev, wraps, n_ev, n_after.sum(),
                        n_after.max()])


def make_chunk_stats_fn(n_of: Callable, head_of: Callable,
                        wrap_of: Callable):
    """``stats_fn(state, window, actives)``: one chunk's stat vector at
    once (``chunk_stats`` on a batch of one), from the pre-chunk state
    (``n_of`` / ``head_of`` / ``wrap_of`` read its ``(S,)`` occupancy,
    ring head and modulus) and the ``(T, S)`` bool active mask."""

    def stats_fn(state, window, actives) -> torch.Tensor:
        return chunk_stats(n_of(state)[None], head_of(state)[None],
                           wrap_of(state)[None], window, actives[None])

    return stats_fn


def combine(acc: torch.Tensor, stat: torch.Tensor) -> torch.Tensor:
    """One stat vector accumulated into another: sums, and a max where
    ``STAT_KEYS`` marks one."""
    out = acc + stat
    for i in _MAX_MASK_IDX:
        out[i] = torch.maximum(acc[i], stat[i])
    return out


class TickStats:
    """Accumulator of the engines' per-chunk stat vectors.

    ``record(pre, window, actives)`` keeps a chunk's pre-chunk ``(3, S)``
    ``n``/``head``/``wrap`` copy and its ``(T, S)`` active mask (the
    caller's copies), and every ``flush_every`` chunks ``flush()``
    computes their stats and ``fold``s them (all on the device, no host
    sync). ``drain()`` flushes, copies the accumulator to host ints,
    publishes them to ``metrics`` as ``engine_<stat>_total`` counters
    (``engine_<stat>`` gauges for the watermarks) and resets it.
    """

    def __init__(self, metrics=None, *, engine: str = "classification"):
        self.metrics = metrics
        self.engine = engine
        self.flush_every = FLUSH_EVERY
        self._acc: torch.Tensor | None = None
        self._pending: dict[tuple[int, int], list] = {}
        self._n_pending = 0
        self.totals: dict[str, int] = {k: 0 for k in STAT_KEYS}

    def fold(self, vec: torch.Tensor) -> None:
        self._acc = vec if self._acc is None else combine(self._acc, vec)

    def record(self, pre: torch.Tensor, window: int, actives) -> None:
        """Keep one chunk for the next ``flush``: ``pre (3, S)`` its
        pre-chunk ``n``, ``head``, ``wrap`` and ``actives (T, S)`` bool,
        neither changed afterwards."""
        key = (int(window), actives.shape[0])
        self._pending.setdefault(key, []).append((pre, actives))
        self._n_pending += 1
        if self._n_pending >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        """Fold the recorded chunks' stats, one ``chunk_stats`` a group
        of chunks with the same window and length."""
        for (window, _), chunks in self._pending.items():
            pre = torch.stack([c[0] for c in chunks])  # (C, 3, S)
            acts = torch.stack([c[1] for c in chunks])  # (C, T, S)
            self.fold(chunk_stats(pre[:, 0], pre[:, 1], pre[:, 2], window,
                                  acts))
        self._pending = {}
        self._n_pending = 0

    def reset(self) -> None:
        """Discard the pending chunks, the accumulator and the totals
        unpublished."""
        self._acc = None
        self._pending = {}
        self._n_pending = 0
        self.totals = {k: 0 for k in STAT_KEYS}

    def drain(self) -> dict[str, int]:
        """Flush, sync, publish and reset; returns this drain's host
        values."""
        self.flush()
        if self._acc is None:
            return {k: 0 for k in STAT_KEYS}
        vals = dict(zip(STAT_KEYS, (int(v) for v in self._acc.tolist())))
        self._acc = None
        for k, v in vals.items():
            if k in _MAX_KEYS:
                self.totals[k] = max(self.totals[k], v)
            else:
                self.totals[k] += v
        if self.metrics is not None:
            for k, v in vals.items():
                if k in _MAX_KEYS:
                    self.metrics.gauge(f"engine_{k}", engine=self.engine).set(
                        self.totals[k])
                else:
                    self.metrics.counter(f"engine_{k}_total",
                                         engine=self.engine).inc(v)
        return vals


__all__ = ["FLUSH_EVERY", "STAT_KEYS", "TickStats", "chunk_stats", "combine",
           "make_chunk_stats_fn"]
