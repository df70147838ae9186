"""Invariant audit of the port's serving engines, counterpart of
``repro/analysis/audit.py`` restated for eager PyTorch.

``python -m repro_torch.analysis.audit [--device cuda|cpu] [--quick]
[--out F]`` builds every engine configuration of the serving matrix
(classification / regression x sliding / grow x ring / compact x shards
1 and 8) plus the registry measures (knn, simplified_knn, kde,
lssvm, bootstrap, knn_regression), runs the checkers below on each, and
writes a JSON report in the JAX audit's layout (``checks``, ``summary``,
``ok``, ``targets``; ``torch`` and ``device`` in place of ``jax`` and
``backend``). It exits nonzero on any violation. The JAX audit reads
compiled HLO; eager PyTorch has none, so each invariant is checked where
it shows at run time instead, on a small engine (``_S, _CAP, _DIM, _K,
_CHUNK``, the JAX audit's shape). A target of 8 shards splits the 16
tenants across 8 devices, two lanes a shard (the JAX audit's waiver: one
lane a device is a degenerate batch): the visible cards where there are
8, else 8 logical shards on the one device (``devices=[dev] * 8``).

Checkers (name -> invariant -> the JAX checker it restates):

* ``in-place`` (``donation-alias``) — across an ``observe`` tick and an
  ``observe_many`` chunk every state leaf keeps its storage
  (``untyped_storage().data_ptr()``), ``D`` (the ``(S, cap, cap)``
  distance carry) first: the state is updated in place, as the JAX
  engines' donated buffers are.
* ``dense-budget`` — a ``TorchDispatchMode`` records one chunk; on ring
  targets no op may *allocate* a fresh tensor of at least ``S * cap *
  cap`` elements (an in-place write into ``D`` or a view of it aliases an
  input and does not count). On the CPU a hand kernel runs its plain
  version, whose temporaries stand in for the kernel's registers: ops
  dispatched inside a kernel's wrapper there are attributed to the kernel
  (reported, not counted). The compact sliding layout carries the JAX
  waiver: it IS the O(cap^2) compaction baseline.
* ``steady-state`` (``retrace``) — a scripted lifecycle (3 ``observe``,
  1 ``observe_many``, one read) runs three times on a fresh engine. The
  first run is the warm-up: the kernel build and the engine's one-time
  occupancy check, the counterpart of JAX's compilations. The second and
  third must dispatch the same op sequence (name, shapes, dtypes), launch
  the same hand kernels the same number of times, and build no kernel.
  This is the precondition of a CUDA-graph capture.
* ``host-sync`` — on the card, the steady lifecycle runs under
  ``torch.cuda.set_sync_debug_mode("error")``: a synchronisation with the
  host raises. On the CPU it reports ``skipped``.
* ``collective-freedom`` — on a sharded target, the port's counterpart
  of a tick whose HLO holds no collective: across an ``observe_many``
  chunk no state leaf of one shard takes data from another (every
  tensor a ``TorchDispatchMode`` sees carries the shards its inputs came
  from; a leaf written from another shard's data is a violation), every
  leaf keeps its storage and stays on its shard's device, and the chunk
  is bitwise that of its ``shards=1`` twin (state gathered, p-values),
  and ``analysis.census.Census`` counts no collective in it (the
  reference's own reading of the HLO). A hand kernel writes outside the
  dispatcher, so on the card the taint
  follows the PyTorch ops around the kernels; the kernels' arguments are
  one shard's by construction. ``skipped`` at one shard.
* ``source-lint`` — ``repro_torch.analysis.lint`` over ``src/repro_torch``.

The registry measures are exact-shape host-driven predictors with no
fixed-shape tick: ``source-lint`` covers them and their other checks
report ``skipped`` with the reason, as the JAX audit does for bootstrap.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch._device import resolve
from repro_torch.analysis import lint as lint_m
from repro_torch.analysis.census import Census

#: engine-matrix shape, the JAX audit's
_S, _CAP, _DIM, _K, _CHUNK = 16, 32, 4, 3, 4

MEASURES = ("knn", "simplified_knn", "kde", "lssvm", "bootstrap",
            "knn_regression")

#: the JAX audit's waiver, for the compact sliding layout
COMPACT_WAIVER = ("compact positional layout IS the O(cap^2) compaction "
                  "baseline (the ring's bit-oracle)")
#: the compact tick rebuilds its lists and counts by design
COMPACT_INPLACE_WAIVER = ("compact positional layout rebuilds its leaves "
                          "each tick by design: the ring's bit-oracle, "
                          "not a serving path")

@dataclass
class AuditTarget:
    """One audited configuration with its waivers."""

    name: str
    kind: str                    # "engine" | "measure"
    family: str = ""             # classification | regression
    mode: str = ""               # sliding | grow
    layout: str = "ring"
    measure: str = ""
    n_sessions: int = _S
    capacity: int = _CAP
    dim: int = _DIM
    k: int = _K
    window: int | None = _CAP
    chunk: int = _CHUNK
    shards: int = 1
    dense_waiver: str = ""
    inplace_waiver: str = ""

    def describe(self) -> dict:
        d = {"name": self.name, "kind": self.kind, "shards": self.shards}
        if self.kind == "engine":
            d.update(family=self.family, mode=self.mode,
                     layout=self.layout, n_sessions=self.n_sessions,
                     capacity=self.capacity)
        else:
            d["measure"] = self.measure
        return d


#: the audited shard counts (the JAX audit's, at two lanes a shard)
SHARD_GRID = (1, 8)


def engine_matrix(quick: bool = False) -> list:
    """Engine targets: family x mode x layout x shards (``quick`` drops
    grow + compact and the sharded targets, as the JAX audit's does)."""
    targets = []
    for family in ("classification", "regression"):
        for mode in ("sliding", "grow"):
            for layout in ("ring", "compact"):
                for shards in SHARD_GRID:
                    if quick and ((mode, layout) == ("grow", "compact")
                                  or shards > 1):
                        continue
                    targets.append(_engine_target(family, mode, layout,
                                                  shards))
    return targets


def _engine_target(family, mode, layout, shards) -> AuditTarget:
    name = f"{family}-{mode}-{layout}" + (f"-s{shards}" if shards > 1
                                          else "")
    t = AuditTarget(name=name, kind="engine", family=family, mode=mode,
                    layout=layout, shards=shards)
    if layout == "compact":
        t.inplace_waiver = COMPACT_INPLACE_WAIVER
        if mode == "sliding":
            t.dense_waiver = COMPACT_WAIVER
    return t


def measure_matrix(quick: bool = False) -> list:
    names = ("knn", "lssvm", "bootstrap") if quick else MEASURES
    return [AuditTarget(name=f"measure-{m}", kind="measure", measure=m)
            for m in names]


# ---------------------------------------------------------------------------
# recording what runs
# ---------------------------------------------------------------------------


def _kernel_wrapper_files() -> frozenset:
    """Source files of the hand kernels' wrappers (on the CPU each runs
    its plain version)."""
    from repro_torch.kernels import ops
    return frozenset(inspect.getsourcefile(fn)
                     for fn in ops.KERNELS.values())


def _inside(files: frozenset) -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename in files:
            return True
        f = f.f_back
    return False


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class OpRecorder(TorchDispatchMode):
    """Records every aten op dispatched inside it: ``ops`` holds (name,
    argument shapes and dtypes); ``fresh`` the outputs of at least
    ``min_numel`` elements whose storage aliases no input (fresh
    allocations), as (name, shape, attributed to a kernel's plain
    version)."""

    def __init__(self, min_numel: int | None = None):
        super().__init__()
        self.min_numel = min_numel
        self.ops: list = []
        self.fresh: list = []
        self._kernels = _kernel_wrapper_files()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat_in, _ = tree_flatten((args, kwargs))
        ins = [a for a in flat_in if isinstance(a, torch.Tensor)]
        self.ops.append((str(func), tuple((tuple(a.shape), str(a.dtype))
                                          for a in ins)))
        out = func(*args, **kwargs)
        if self.min_numel is not None:
            seen = {_storage(a) for a in ins}
            flat_out, _ = tree_flatten(out)
            for o in flat_out:
                if isinstance(o, torch.Tensor) \
                        and o.numel() >= self.min_numel \
                        and _storage(o) not in seen:
                    self.fresh.append({
                        "op": str(func), "shape": list(o.shape),
                        "kernel_plain": (o.device.type == "cpu"
                                         and _inside(self._kernels))})
        return out


# ---------------------------------------------------------------------------
# the engine under audit
# ---------------------------------------------------------------------------


def _leaf_names(family: str) -> list:
    return (["X", "y", "best", "n", "D", "head", "aid", "wrap"]
            if family == "classification" else
            ["X", "y", "D", "nbr_d", "nbr_y", "n", "head", "aid", "wrap",
             "nbr_a"])


def shard_devices(device: torch.device, shards: int) -> list:
    """``shards`` devices of ``device``'s kind: the visible cards where
    there are that many, else ``shards`` logical shards on ``device``."""
    from repro_torch.core.distributed import visible_devices
    devs = visible_devices(device)
    return devs[:shards] if len(devs) >= shards else [device] * shards


def _leaf_tags(target) -> list:
    """A state's leaf names in ``leaves()`` order (``name@shard`` on a
    sharded target)."""
    names = _leaf_names(target.family)
    if target.shards == 1:
        return names
    return [f"{n}@{i}" for i in range(target.shards) for n in names]


def _launches() -> dict:
    from repro_torch.kernels import ops
    return ops.kernel_launches()


def _built() -> bool:
    from repro_torch.kernels import _build
    return _build._lib is not None


class Artifact:
    """One target's engine and its recorded runs (built lazily, shared
    across checkers). ``engine_hook(engine)`` may replace the engine's
    tick (the planted faults of the tests)."""

    def __init__(self, target: AuditTarget, device, engine_hook=None):
        self.target = target
        self.device = torch.device(device)
        self.engine_hook = engine_hook
        self._passes = None

    def build_engine(self, shards: int | None = None):
        """The target's engine (``shards``: another shard count, the
        collective check's one-shard twin)."""
        t = self.target
        shards = t.shards if shards is None else shards
        kw = dict(n_sessions=t.n_sessions, capacity=t.capacity, dim=t.dim,
                  k=t.k, window=t.window if t.mode == "sliding" else None,
                  layout=t.layout, device=self.device, shards=shards,
                  devices=shard_devices(self.device, shards))
        if t.family == "classification":
            from repro_torch.serving.engine import ServingEngine
            eng = ServingEngine(n_labels=2, **kw)
        else:
            from repro_torch.regression.engine import \
                RegressionServingEngine
            eng = RegressionServingEngine(**kw)
        if self.engine_hook is not None:
            self.engine_hook(eng)
        return eng

    def traffic(self, T: int, i: int):
        """``T`` ticks of fixed traffic, ``i`` varying the features."""
        t, dev = self.target, self.device
        xs = torch.full((T, t.n_sessions, t.dim), 0.1 * (i + 1),
                        device=dev)
        xs += torch.arange(t.n_sessions, device=dev)[None, :, None] * 0.01
        ydt = torch.int32 if t.family == "classification" else torch.float32
        ys = (torch.arange(T * t.n_sessions, device=dev) % 2).to(ydt)
        taus = torch.full((T, t.n_sessions), 0.5, device=dev)
        return xs, ys.view(T, t.n_sessions), taus

    def lifecycle(self, eng, state):
        """3 ``observe``, 1 ``observe_many`` of ``chunk`` ticks, one
        read."""
        t = self.target
        for i in range(3):
            x, y, tau = self.traffic(1, i)
            state, _ = eng.observe(state, x[0], y[0], tau[0])
        state, _ = eng.observe_many(state, *self.traffic(t.chunk, 3))
        xq = torch.zeros((2, t.dim), device=self.device)
        if t.family == "classification":
            eng.predict(state, xq)
        else:
            eng.intervals(state, xq, 0.1)
        return state

    def passes(self) -> list:
        """The lifecycle three times on a fresh engine: per pass its op
        sequence, the hand kernels it launched and whether it built the
        kernel library."""
        if self._passes is None:
            eng = self.build_engine()
            state = eng.init_state()
            self._passes = []
            for _ in range(3):
                built, before = _built(), _launches()
                with OpRecorder() as rec:
                    state = self.lifecycle(eng, state)
                after = _launches()
                self._passes.append({
                    "ops": rec.ops,
                    "launches": {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]},
                    "built": _built() and not built})
            self.engine, self.state = eng, state
        return self._passes


# ---------------------------------------------------------------------------
# checkers
# ---------------------------------------------------------------------------

CHECKERS: dict = {}


def checker(name: str):
    def deco(fn):
        CHECKERS[name] = fn
        return fn
    return deco


def _result(name, target, status, violations=None, info=None) -> dict:
    return {"check": name, "target": target.name,
            "status": status, "violations": violations or [],
            "info": info or {}}


@checker("in-place")
def check_in_place(target: AuditTarget, art: Artifact) -> dict:
    eng = art.build_engine()
    state = eng.init_state()
    names = _leaf_tags(target)
    order = sorted(range(len(names)),
                   key=lambda i: names[i].split("@")[0] != "D")

    def ptrs(st):
        return [_storage(leaf) for leaf in st.leaves()]

    base = ptrs(state)
    x, y, tau = art.traffic(1, 0)
    state, _ = eng.observe(state, x[0], y[0], tau[0])
    after_tick = ptrs(state)
    state, _ = eng.observe_many(state, *art.traffic(target.chunk, 1))
    after_chunk = ptrs(state)
    moved = []
    for i in order:
        for when, now in (("observe", after_tick),
                          ("observe_many", after_chunk)):
            if now[i] != base[i]:
                moved.append({"kind": "leaf-reallocated", "leaf": names[i],
                              "after": when,
                              "line": f"state leaf {names[i]} changed "
                                      f"storage across {when}"})
                break
    info = {"leaves": [names[i] for i in order]}
    if target.inplace_waiver:
        info.update(waiver=target.inplace_waiver,
                    measured=[m["leaf"] for m in moved])
        return _result("in-place", target, "waived", [], info)
    return _result("in-place", target, "fail" if moved else "pass", moved,
                   info)


@checker("dense-budget")
def check_dense(target: AuditTarget, art: Artifact) -> dict:
    t = target
    # a sharded target's D is a shard's lanes: one shard's (S/N, cap, cap)
    min_numel = t.n_sessions // t.shards * t.capacity * t.capacity
    eng = art.build_engine()
    state = eng.init_state()
    state, _ = eng.observe_many(state, *art.traffic(t.chunk, 0))  # warm-up
    with OpRecorder(min_numel) as rec:
        eng.observe_many(state, *art.traffic(t.chunk, 1))
    vs = [dict(f, kind="dense-allocation",
               line=f"{f['op']} allocates {f['shape']} "
                    f"(>= S*cap*cap = {min_numel} elements) in a chunk")
          for f in rec.fresh if not f["kernel_plain"]]
    info = {"min_numel": min_numel, "ops_recorded": len(rec.ops),
            "kernel_plain_allocations": sum(f["kernel_plain"]
                                            for f in rec.fresh)}
    if t.dense_waiver:
        info.update(waiver=t.dense_waiver, measured=len(vs))
        return _result("dense-budget", t, "waived", [], info)
    return _result("dense-budget", t, "fail" if vs else "pass", vs, info)


@checker("steady-state")
def check_steady(target: AuditTarget, art: Artifact) -> dict:
    warm, first, second = art.passes()
    vs = []
    if first["ops"] != second["ops"]:
        at = next((i for i, (a, b) in enumerate(zip(first["ops"],
                                                   second["ops"]))
                   if a != b), min(len(first["ops"]), len(second["ops"])))
        vs.append({"kind": "op-sequence",
                   "line": f"repeat lifecycle dispatched "
                           f"{len(second['ops'])} ops against "
                           f"{len(first['ops'])}; first difference at op "
                           f"{at}: "
                           f"{(first['ops'] + [None])[at]} -> "
                           f"{(second['ops'] + [None])[at]}"})
    if first["launches"] != second["launches"]:
        vs.append({"kind": "kernel-launches",
                   "line": f"repeat lifecycle launched "
                           f"{second['launches']} against "
                           f"{first['launches']}"})
    if first["built"] or second["built"]:
        vs.append({"kind": "kernel-build",
                   "line": "a kernel was built after the warm-up "
                           "lifecycle"})
    info = {"ops_per_pass": [len(p["ops"]) for p in (warm, first, second)],
            "launches_per_pass": second["launches"],
            "warm_up_built": warm["built"]}
    return _result("steady-state", target, "fail" if vs else "pass", vs,
                   info)


def _where(e: BaseException) -> str:
    """The innermost frames of the port in ``e``'s traceback."""
    frames = [f for f in traceback.extract_tb(e.__traceback__)
              if f"{os.sep}repro_torch{os.sep}" in f.filename]
    return " <- ".join(
        f"{f.filename.split(os.sep + 'repro_torch' + os.sep)[-1]}:"
        f"{f.lineno} {f.name}" for f in frames[::-1][:3])


@checker("host-sync")
def check_host_sync(target: AuditTarget, art: Artifact) -> dict:
    if art.device.type != "cuda":
        return _result("host-sync", target, "skipped",
                       info={"reason": "no card: set_sync_debug_mode sees "
                                       "CUDA synchronisations only"})
    art.passes()  # the warm-up (one-time checks) has run
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        art.state = art.lifecycle(art.engine, art.state)
        vs = []
    except RuntimeError as e:
        vs = [{"kind": "host-sync", "where": _where(e),
               "line": f"{str(e).splitlines()[0]} at {_where(e)}"}]
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    return _result("host-sync", target, "fail" if vs else "pass", vs,
                   {"mode": "error"})


class TaintRecorder(TorchDispatchMode):
    """Follows which tenant shards' state each tensor's data came from:
    ``taint`` maps a storage to the shards of the state it was computed
    from, starting from ``owner`` (each state leaf's storage -> its
    shard); an op's outputs carry the union of its inputs' shards (an
    in-place op's output is one of its inputs, so its shards add up)."""

    def __init__(self, owner: dict):
        super().__init__()
        self.taint = {k: {v} for k, v in owner.items()}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat_in, _ = tree_flatten((args, kwargs))
        src = set()
        for a in flat_in:
            if isinstance(a, torch.Tensor) and a.numel():
                src |= self.taint.get(_storage(a), set())
        out = func(*args, **kwargs)
        flat_out, _ = tree_flatten(out)
        for o in flat_out:
            if isinstance(o, torch.Tensor) and o.numel():
                self.taint[_storage(o)] = set(src)
        return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a.cpu(), b.cpu())


@checker("collective-freedom")
def check_collectives(target: AuditTarget, art: Artifact) -> dict:
    if target.shards == 1:
        return _result("collective-freedom", target, "skipped",
                       info={"reason": "one shard, no sharded tick"})
    from repro_torch.core import distributed as dist
    eng, twin = art.build_engine(), art.build_engine(shards=1)
    state, tstate = eng.init_state(), twin.init_state()
    state, _ = eng.observe_many(state, *art.traffic(target.chunk, 0))
    tstate, _ = twin.observe_many(tstate, *art.traffic(target.chunk, 0))
    ptrs = [_storage(leaf) for leaf in state.leaves()]
    owner = {_storage(leaf): i for i, part in enumerate(state.parts)
             for leaf in part.leaves()}
    with Census() as census, TaintRecorder(owner) as rec:
        state, p = eng.observe_many(state, *art.traffic(target.chunk, 1))
    tstate, tp = twin.observe_many(tstate, *art.traffic(target.chunk, 1))
    # the reference's reading: no collective in the tick's program
    vs = [{"kind": "collective", "line": f"the sharded chunk ran {kind} "
           f"({nbytes:.0f} bytes)"}
          for kind, nbytes in census.collective_bytes.items()]
    for i, part in enumerate(state.parts):
        dev = eng.mesh.flat()[i]
        for name, leaf in zip(_leaf_names(target.family), part.leaves()):
            other = sorted(rec.taint.get(_storage(leaf), set()) - {i})
            if other:
                vs.append({"kind": "cross-shard", "leaf": f"{name}@{i}",
                           "line": f"state leaf {name} of shard {i} holds "
                                   f"data of shard(s) {other}"})
            if leaf.device != dev:
                vs.append({"kind": "leaf-moved", "leaf": f"{name}@{i}",
                           "line": f"state leaf {name} of shard {i} is on "
                                   f"{leaf.device}, not {dev}"})
    moved = [tag for tag, a, b in zip(_leaf_tags(target), ptrs,
                                      (_storage(x) for x in state.leaves()))
             if a != b]
    if not target.inplace_waiver:  # the compact layout rebuilds leaves
        vs += [{"kind": "leaf-reallocated", "leaf": tag,
                "line": f"state leaf {tag} changed storage across a "
                        "sharded chunk"} for tag in moved]
    whole = dist.gather_tenants(state)
    same = (_same_bits(p, tp) and all(
        _same_bits(a, b) for a, b in zip(whole.leaves(), tstate.leaves())))
    if not same:
        vs.append({"kind": "twin-mismatch",
                   "line": f"the {target.shards}-shard chunk differs from "
                           "its one-shard twin (state or p-values)"})
    info = {"shards": target.shards,
            "devices": [str(d) for d in eng.mesh.flat()],
            "collective_bytes": dict(census.collective_bytes),
            "storages_followed": len(rec.taint),
            "leaves_reallocated": len(moved)}
    return _result("collective-freedom", target, "fail" if vs else "pass",
                   vs, info)


def check_source_lint(src_root: str) -> dict:
    vs = [v.as_dict() for v in lint_m.lint_tree(src_root)]
    return {"check": "source-lint", "target": "src",
            "status": "fail" if vs else "pass", "violations": vs,
            "info": {"rules": list(lint_m.RULE_NAMES),
                     "not_ported": lint_m.NOT_PORTED, "root": src_root}}


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------


def run_audit(device=None, quick: bool = False) -> dict:
    """Run the checkers over the matrix; returns the JSON report.
    ``device``: ``cuda`` by default (raises without a GPU)."""
    dev = resolve(device)
    t0 = time.perf_counter()
    src_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    targets = engine_matrix(quick) + measure_matrix(quick)

    results = [check_source_lint(src_root)]
    for t in targets:
        if t.kind == "measure":
            results += [_result(name, t, "skipped", info={
                "reason": "registry predictor: exact-shape host-driven API "
                          "without a fixed-shape tick (sources gated by "
                          "source-lint)"}) for name in CHECKERS]
            continue
        art = Artifact(t, dev)
        results += [fn(t, art) for fn in CHECKERS.values()]

    summary = {"pass": 0, "fail": 0, "waived": 0, "skipped": 0}
    for r in results:
        summary[r["status"]] += 1
    return {
        "torch": torch.__version__,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "matrix": {"engine_targets": sum(
                       1 for t in targets if t.kind == "engine"),
                   "measure_targets": sum(
                       1 for t in targets if t.kind == "measure"),
                   "quick": quick},
        "targets": [t.describe() for t in targets],
        "checks": results,
        "summary": summary,
        "elapsed_s": round(time.perf_counter() - t0, 3),
        "ok": summary["fail"] == 0,
    }


def format_summary(report: dict) -> str:
    s = report["summary"]
    lines = [f"audit: {s['pass']} pass, {s['fail']} fail, "
             f"{s['waived']} waived, {s['skipped']} skipped "
             f"({report['matrix']['engine_targets']} engine + "
             f"{report['matrix']['measure_targets']} measure targets on "
             f"{report['device']}, {report['elapsed_s']:.1f}s)"]
    for r in report["checks"]:
        if r["status"] != "fail":
            continue
        lines.append(f"  FAIL {r['check']} @ {r['target']}")
        for v in r["violations"][:4]:
            lines.append(f"    {v.get('line', v)}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="invariant audit over the port's engine matrix (see "
                    "the module docstring)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", default="audit_report.json",
                    help="JSON report path")
    ap.add_argument("--quick", action="store_true",
                    help="reduced matrix (grow + compact and half the "
                    "measures left out)")
    args = ap.parse_args(argv)
    report = run_audit(device=args.device, quick=args.quick)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    print(format_summary(report))
    print(f"report -> {args.out}")
    return 0 if report["ok"] else 1


__all__ = ["AuditTarget", "Artifact", "CHECKERS", "MEASURES",
           "OpRecorder", "SHARD_GRID", "TaintRecorder", "engine_matrix",
           "measure_matrix", "run_audit", "format_summary", "main",
           "shard_devices"]


if __name__ == "__main__":
    raise SystemExit(main())
