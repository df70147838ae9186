"""Tenant-state snapshot and restore for the serving engines, counterpart
of ``repro/serving/snapshot.py``.

``SessionStore`` writes an engine's batched state through
``checkpoint.store.CheckpointStore`` (atomic commit, per-shard checksums,
walk-back restore), with the engine's ``meta()`` in the manifest's
``extra``, so ``restore_engine`` rebuilds the engine and its state from a
bare directory::

    store = SessionStore("/var/lib/cp-serving")
    store.save(step, state, meta=engine.meta())        # while serving
    engine, state, step = SessionStore(root).restore_engine()  # restart

The format is the JAX package's: either package restores the other's
snapshots, the 8-leaf classification ``Session``, the 10-leaf regression
``RegStreamState`` and the pre-ring 5/6-leaf linear forms alike.

``AsyncShardedSaver`` takes the snapshot off the serving loop: ``save``
clones the state on the device in tenant blocks (so the next in-place
tick cannot reach it), and a worker thread copies the blocks to pinned
host memory on a stream of its own and commits them, retrying transient
write errors on a keyed backoff.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any

import torch

from repro_torch._device import BIG
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core.online import OnlineKnnState
from repro_torch.regression.engine import RegressionServingEngine
from repro_torch.regression.stream import RegStreamState
from repro_torch.robustness.faults import (PermanentWriteError,
                                           backoff_schedule)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.session import Session


def _treedef(state) -> str:
    t = type(state)
    return f"{t.__module__}.{t.__qualname__}"


def _like_from_manifest(manifest: dict):
    """The builder of a restored step's leaves, chosen by their count: 8
    leaves are a classification ``Session`` (X, y, best, n, D, head, aid,
    wrap), 10 a regression ``RegStreamState`` (X, y, D, nbr_d, nbr_y, n,
    head, aid, wrap, nbr_a); the pre-ring 5 / 6-leaf linear snapshots stay
    a plain list that ``_from_legacy`` upgrades. Any other count raises,
    which walks a restore back to an earlier step."""
    n = len(manifest["leaves"])
    if n in (5, 6):
        return list
    if n == 8:
        return Session.from_leaves
    if n == 10:
        return RegStreamState.from_leaves
    raise ValueError(
        f"snapshot has {n} leaves; expected 8 (classification Session), "
        "10 (regression RegStreamState), or the legacy 5/6 linear forms "
        "— not a serving snapshot?")


def _from_legacy(leaves):
    """A pre-ring linear snapshot upgraded to the ring layout: rows
    ``[0, n)`` in arrival order are a ring at head 0 with a full-capacity
    modulus and positional arrival ids. The regression neighbours'
    arrival ids, which the legacy form never stored, are rebuilt from the
    saved distances: each row's k smallest, ties to the lowest index (the
    JAX ``lax.top_k`` rule, a stable sort), 0 where the distance is
    BIG."""
    if len(leaves) == 5:
        X, y, best, n, D = leaves
    else:
        X, y, D, nbr_d, nbr_y, n = leaves
    cap = D.shape[-1]
    head = torch.zeros_like(n)
    pos = torch.arange(cap, dtype=torch.int32, device=D.device).expand(
        y.shape)
    aid = torch.where(pos < n[..., None], pos, 0)
    wrap = torch.full_like(n, cap)
    if len(leaves) == 5:
        return Session(OnlineKnnState(X, y, best, n), D, head, aid, wrap)
    k = nbr_d.shape[-1]
    vals, idx = torch.sort(D, dim=-1, stable=True)
    nbr_a = torch.where(vals[..., :k] >= BIG, 0, idx[..., :k]).to(
        torch.int32)
    return RegStreamState(X, y, D, nbr_d, nbr_y, n, head, aid, wrap, nbr_a)


def _fit_ring_modulus(engine, state):
    """A restored state's ring modulus aligned with ``engine``'s window
    block, where that is only a relabelling: a legacy snapshot restores
    with a full-capacity modulus, and an unwrapped state (head 0) that
    fits the window can take the block's. Anything else is left for the
    engine's occupancy check to reject."""
    if engine._wmax is None:
        return state
    lo, hi = int(state.wrap.min()), int(state.wrap.max())
    if lo == engine._wmax and hi == engine._wmax:
        return state
    if int(state.head.max()) != 0 or int(state.n.max()) > engine._wmax:
        return state
    state.wrap = torch.full_like(state.wrap, engine._wmax)
    return state


class SessionStore:
    """Crash-safe snapshot store of (batched) serving states.

    ``metrics`` / ``tracer`` (optional, ``repro_torch.telemetry``) time
    every save and restore: histograms ``snapshot_save_s`` /
    ``snapshot_restore_s`` and one trace record a call. A background
    ``save`` measures the copy to the host and the hand-off (what the
    serving loop pays); ``blocking=True`` measures through the commit.
    """

    def __init__(self, root: str, keep: int = 3, *, metrics=None,
                 tracer=None, injector=None):
        self.root = root
        self._store = CheckpointStore(root, keep=keep, injector=injector)
        self._metrics = metrics
        self._tracer = tracer

    def _timed(self, op: str, fn, *, tenants=None):
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        if self._metrics is not None:
            self._metrics.histogram(f"{op}_s").observe(wall)
        if self._tracer is not None:
            self._tracer.record(op, wall, tenants=tenants)
        return out

    def save(self, step: int, state, *, meta: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot ``state`` (a ``Session`` or a ``RegStreamState``);
        ``meta`` (``engine.meta()``) rides in the manifest. In the
        background by default: call ``wait()`` before exit."""
        self._timed(
            "snapshot_save",
            lambda: self._store.save(step, state.leaves(),
                                     treedef=_treedef(state),
                                     blocking=blocking, extra=meta or {}))

    def wait(self) -> None:
        self._store.wait()

    def latest_step(self) -> int | None:
        return self._store.latest_step()

    def discard(self, step: int) -> None:
        """Drop a step so ``latest_step`` never points at it."""
        self._store.discard(step)

    def restore(self, step: int | None = None, *, device=None
                ) -> tuple[Any, int, dict[str, Any]]:
        """``(state, step, meta)`` on ``device`` (``cuda`` by default),
        shapes from the manifest. Without ``step`` a corrupted latest
        snapshot falls back to the previous committed one
        (``restore_fallback_total`` counts each skipped step); an explicit
        ``step`` raises on corruption."""
        def on_fallback(s, exc):
            if self._metrics is not None:
                self._metrics.counter("restore_fallback_total").inc()

        def restore():
            state, s = self._store.restore(
                _like_from_manifest, step, on_fallback=on_fallback,
                device=device)
            if isinstance(state, list):  # legacy 5/6-leaf linear snapshot
                state = _from_legacy(state)
            return state, s, self._store.read_manifest(s).get("extra", {})

        return self._timed("snapshot_restore", restore)

    def restore_engine(self, step: int | None = None, device=None):
        """``(engine, state, step)`` from a snapshot saved with
        ``meta=engine.meta()`` (of either package): a ``ServingEngine``,
        or a ``RegressionServingEngine`` when the meta's mode is
        regression, on ``device`` (``cuda`` by default). Tenants,
        capacity and dim come from the saved arrays; k, n_labels, window
        and dtype from the meta."""
        state, step, meta = self.restore(step, device=device)
        if "k" not in meta:
            raise ValueError(
                f"snapshot step {step} carries no engine meta (saved "
                "without meta=engine.meta()?) — use restore() and "
                "construct the ServingEngine yourself")
        regression = isinstance(state, RegStreamState)
        if regression != (meta.get("mode") == "regression"):
            raise ValueError(
                f"snapshot step {step}: state/meta mode mismatch "
                f"({type(state).__name__} vs meta mode "
                f"{meta.get('mode')!r})")
        X = state.X if regression else state.knn.X
        meta = {**meta, "n_sessions": int(state.D.shape[0]),
                "capacity": int(state.D.shape[-1]), "dim": int(X.shape[-1])}
        cls = RegressionServingEngine if regression else ServingEngine
        engine = cls.from_meta(meta, device=state.D.device)
        return engine, _fit_ring_modulus(engine, state), step


class AsyncShardedSaver:
    """Snapshots written off the serving loop, through a ``SessionStore``.

    ``save(step, state)`` clones the state on the device in ``shards``
    tenant blocks (the clones are the snapshot: the next in-place tick
    cannot change them), records a CUDA event after the clones and
    queues them. A worker thread waits on that event on a stream of its
    own, copies the blocks into pinned host buffers there (so the copies
    overlap the next ticks), and commits the full state through the
    store's atomic write. The queue holds at most ``depth`` snapshots
    (backpressure instead of unbounded device memory).

    A transient write error (``OSError``, the chaos harness's
    ``TransientWriteError`` among them) is retried up to ``retries``
    times on the keyed schedule ``faults.backoff_schedule(seed, step,
    ...)``, counted in ``snapshot_retries_total``; anything else,
    ``PermanentWriteError`` included, fails the step at once. A failed
    step is discarded from the store (``snapshot_failed_steps_total``)
    and its error raised by the next ``save`` / ``wait``.
    """

    def __init__(self, store: SessionStore, shards: int, *, depth: int = 2,
                 metrics=None, retries: int = 3, retry_base_s: float = 0.05,
                 seed: int = 0):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.store = store
        self.shards = shards
        self.retries = int(retries)
        self.retry_base_s = float(retry_base_s)
        self._seed = int(seed)
        self._metrics = metrics
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Exception | None = None
        self._worker = threading.Thread(
            target=self._run, name="sharded-snapshot-saver", daemon=True)
        self._worker.start()

    def _check_err(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async snapshot save failed") from err

    def save(self, step: int, state, *, meta: dict | None = None) -> None:
        """Queue a snapshot of ``state`` (blocks only when ``depth``
        snapshots are already in flight)."""
        self._check_err()
        leaves = state.leaves()
        S = leaves[0].shape[0]
        cuts = [S * i // self.shards for i in range(self.shards + 1)]
        blocks = [[leaf[cuts[i]:cuts[i + 1]].clone() for leaf in leaves]
                  for i in range(self.shards)]
        ready = None
        if leaves[0].is_cuda:
            ready = torch.cuda.Event()
            ready.record()
        self._q.put((step, type(state), blocks, cuts, ready, meta))

    @staticmethod
    def _to_host(blocks, cuts, ready) -> list:
        """The blocks assembled into full host leaves. On the card: one
        pinned buffer a leaf, filled block by block on the worker's own
        stream after the clones' ``ready`` event."""
        if ready is None:
            return [torch.cat(ls) for ls in zip(*blocks)]
        dev = blocks[0][0].device
        stream = torch.cuda.Stream(device=dev)
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            host = [torch.empty((cuts[-1],) + tuple(leaf.shape[1:]),
                                dtype=leaf.dtype, pin_memory=True)
                    for leaf in blocks[0]]
            for i, block in enumerate(blocks):
                for h, leaf in zip(host, block):
                    h[cuts[i]:cuts[i + 1]].copy_(leaf, non_blocking=True)
        stream.synchronize()
        return host

    def _commit_with_retry(self, step: int, full, meta) -> None:
        delays = backoff_schedule(self._seed, step, self.retries,
                                  self.retry_base_s)
        attempt = 0
        while True:
            try:
                self.store.save(step, full, meta=meta, blocking=True)
                return
            except PermanentWriteError:
                raise
            except OSError:
                if attempt >= self.retries:
                    raise
                if self._metrics is not None:
                    self._metrics.counter("snapshot_retries_total").inc()
                time.sleep(delays[attempt])
                attempt += 1

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, cls, blocks, cuts, ready, meta = item
            del item
            try:
                t0 = time.perf_counter()
                full = cls.from_leaves(self._to_host(blocks, cuts, ready))
                del blocks
                self._commit_with_retry(step, full, meta)
                if self._metrics is not None:
                    self._metrics.histogram(
                        "snapshot_async_save_s", shards=self.shards
                    ).observe(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 -- raised by save/wait
                # failed for good: drop the step so latest_step() never
                # points at a half-written snapshot
                self.store.discard(step)
                if self._metrics is not None:
                    self._metrics.counter(
                        "snapshot_failed_steps_total").inc()
                self._err = e
            finally:
                self._q.task_done()

    def wait(self) -> None:
        """Block until every queued snapshot is committed (or failed)."""
        self._q.join()
        self.store.wait()
        self._check_err()

    def close(self) -> None:
        """Drain, stop the worker, and raise any pending error."""
        self._q.put(None)
        self._q.join()
        self._worker.join()
        self.store.wait()
        self._check_err()


__all__ = ["SessionStore", "AsyncShardedSaver"]
