"""Fault-tolerant checkpointing of a flat list of tensors, counterpart of
``repro/checkpoint/store.py``, on the same on-disk format::

    <root>/step_000000420/
        manifest.json         # step, treedef, leaf shapes and dtypes, extra
        shard_00000.npz       # the leaves, cut at 512 MiB on leaf boundaries
        shard_00001.npz
        ...
        COMMITTED             # written LAST: the crash-safe commit marker

The step is written into ``step_%09d.tmp`` and renamed into place after
its ``COMMITTED`` marker, so a preempted writer never leaves a step that
restore would take. The manifest keys, the numpy dtype names, the npz
member names (the leaf index) and the per-shard SHA-256 are the JAX
store's, so each package restores the other's steps: the JAX restore
rebuilds its target from the leaf count and never parses ``treedef``;
the port writes there the name of the state class it saved.

Shards are hashed in fixed-size chunks (the same digest without a second
copy of a multi-GB shard in host memory). Restore returns tensors on the
caller's device (``cuda`` by default). numpy has no bfloat16: a bf16 leaf
is written as its raw 2-byte values (``|V2``, as numpy writes the JAX
store's ``ml_dtypes`` bfloat16 arrays) under the manifest dtype
``bfloat16``, and read back bit for bit.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch._device import resolve

_SHARD_BYTES = 512 * 1024 * 1024  # target bytes per shard file
_HASH_CHUNK = 16 * 1024 * 1024
_STEP_RE = re.compile(r"^step_(\d{9})$")


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:09d}")


def sha256_file(path: str) -> str:
    """SHA-256 hex digest of ``path``, read in fixed-size chunks."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(_HASH_CHUNK):
            h.update(chunk)
    return h.hexdigest()


_BF16_HOST = np.dtype("V2")  # a bf16 leaf's raw values on the host


def host_leaf(x, *, copy: bool) -> np.ndarray:
    """``x`` (tensor or array) as a host numpy array (a bf16 tensor as its
    raw ``|V2`` values); ``copy`` detaches it from a host tensor the
    caller may go on updating in place."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        raw = x.dtype == torch.bfloat16
        if raw:
            x = x.view(torch.int16)
        if x.device.type != "cpu":
            out = x.cpu().numpy()  # a fresh host buffer
        else:
            out = x.numpy().copy() if copy else x.numpy()
        return out.view(_BF16_HOST) if raw else out
    return np.array(x) if copy else np.asarray(x)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == _BF16_HOST else str(a.dtype)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(dtype, copy=False))


class CheckpointStore:
    """Steps of a flat leaf list under ``root``; keeps the newest ``keep``.

    ``injector`` (a ``robustness.faults.FaultInjector``, ``None`` in
    production) is called at the sites ``store.write``, ``store.shard``,
    ``store.manifest`` and ``store.commit`` of every write attempt.
    """

    def __init__(self, root: str, keep: int = 3, *, injector=None):
        self.root = root
        self.keep = keep
        self.injector = injector
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, leaves, *, treedef: str = "list",
             blocking: bool = False, extra: dict | None = None):
        """Copy ``leaves`` to host memory, then write them (in a background
        thread unless ``blocking``). At most one write is outstanding; an
        error of the previous background write is raised here."""
        self.wait()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        # a background write must not see the caller's next in-place tick
        host = [host_leaf(x, copy=not blocking) for x in leaves]

        def write():
            try:
                self._write(step, host, treedef, extra or {})
            except Exception as e:  # noqa: BLE001 -- surfaced on next save
                self._error = e

        if blocking:
            write()
            if self._error is not None:
                err, self._error = self._error, None
                raise err
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _write(self, step: int, host_leaves, treedef: str, extra: dict):
        inj = self.injector
        if inj is not None:
            inj.enter("store.write", step)
        d = _step_dir(self.root, step)
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        shards, cur, cur_bytes = [], [], 0
        for i, arr in enumerate(host_leaves):
            cur.append(i)
            cur_bytes += arr.nbytes
            if cur_bytes >= _SHARD_BYTES:
                shards.append(cur)
                cur, cur_bytes = [], 0
        if cur:
            shards.append(cur)

        manifest = {
            "step": step,
            "treedef": treedef,
            "n_leaves": len(host_leaves),
            "leaves": [{"shape": list(a.shape), "dtype": _dtype_name(a)}
                       for a in host_leaves],
            "shards": [],
            "extra": extra,
            "time": time.time(),
        }
        for si, idxs in enumerate(shards):
            fname = f"shard_{si:05d}.npz"
            path = os.path.join(tmp, fname)
            if inj is not None:
                inj.enter("store.shard", step)
            np.savez(path, **{str(i): host_leaves[i] for i in idxs})
            digest = sha256_file(path)
            if inj is not None:
                # after the checksum: a torn or corrupted write the writer
                # cannot see, which restore's verify catches
                inj.mutate_file("store.shard", step, path)
                digest = inj.mutate_digest("store.manifest", step, digest)
            manifest["shards"].append(
                {"file": fname, "leaves": idxs, "sha256": digest})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if inj is not None:
            inj.enter("store.commit", step)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write(str(step))
        if os.path.exists(d):
            shutil.rmtree(d)
        os.replace(tmp, d)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def flush(self):
        """Wait for the outstanding background write and raise its
        error, if it failed."""
        self.wait()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.committed_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(_step_dir(self.root, s), ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def committed_steps(self) -> list:
        """Committed steps in order; uncommitted step directories (a
        preempted writer's) are removed."""
        out = []
        for name in sorted(os.listdir(self.root)):
            m = _STEP_RE.match(name)
            if not m:
                continue
            if os.path.exists(os.path.join(self.root, name, "COMMITTED")):
                out.append(int(m.group(1)))
            else:
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
        return out

    def latest_step(self) -> int | None:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def read_manifest(self, step: int) -> dict:
        with open(os.path.join(_step_dir(self.root, step),
                               "manifest.json")) as f:
            return json.load(f)

    def discard(self, step: int) -> None:
        """Drop a step's directory and any half-written tmp, so
        ``latest_step`` never points at it. Never raises."""
        shutil.rmtree(_step_dir(self.root, step), ignore_errors=True)
        shutil.rmtree(_step_dir(self.root, step) + ".tmp",
                      ignore_errors=True)

    def restore(self, build=None, step: int | None = None, *,
                verify: bool = True, on_fallback=None, device=None):
        """``(build(manifest)(leaves), step)``: the leaves as tensors on
        ``device`` (``cuda`` by default), in the saved shapes and dtypes,
        handed to the builder that ``build`` returns for that step's
        manifest (``None``: the plain list).

        With ``step=None`` a step that fails to restore (unreadable
        manifest, checksum mismatch, torn shard, a builder that refuses
        it) falls back to the previous committed one, calling
        ``on_fallback(step, exc)`` for each skipped step. An explicit
        ``step`` raises instead.
        """
        dev = resolve(device)
        if step is not None:
            return self._restore_step(build, step, verify, dev)
        steps = self.committed_steps()
        if not steps:
            raise FileNotFoundError(f"no committed checkpoints in "
                                    f"{self.root}")
        last_err = None
        for s in reversed(steps):
            try:
                return self._restore_step(build, s, verify, dev)
            except Exception as e:  # noqa: BLE001 -- walk-back, re-raised
                last_err = e
                if on_fallback is not None:
                    on_fallback(s, e)
        raise IOError(
            f"all {len(steps)} committed step(s) in {self.root} failed "
            f"to restore; last error: {last_err}") from last_err

    def _restore_step(self, build, step: int, verify: bool, dev):
        d = _step_dir(self.root, step)
        manifest = self.read_manifest(step)
        make = list if build is None else build(manifest)
        host = [None] * manifest["n_leaves"]
        for sh in manifest["shards"]:
            path = os.path.join(d, sh["file"])
            if verify and sha256_file(path) != sh["sha256"]:
                raise IOError(f"checksum mismatch in {path}")
            with np.load(path) as z:
                for i in sh["leaves"]:
                    host[i] = z[str(i)]
        out = []
        for spec, arr in zip(manifest["leaves"], host):
            if arr is None or list(arr.shape) != spec["shape"]:
                raise ValueError(
                    f"step {step}: a leaf is missing or its shape "
                    f"disagrees with the manifest's {spec['shape']}")
            out.append(_tensor(arr, spec["dtype"]).to(dev))
        return make(out), step


__all__ = ["CheckpointStore", "sha256_file"]
