"""Source-invariant lint, counterpart of ``repro/analysis/lint.py``: AST
checks over ``src/repro_torch`` that run without executing (or
importing) any of it, restated for eager PyTorch.

Each rule encodes a structural invariant the serving stack's tests and
the smoke rely on:

* ``unkeyed-randomness`` — every random draw must be keyed: module-level
  ``np.random.*`` draws and stdlib ``random`` calls are process-global
  state; so is a ``torch.rand`` / ``randn`` / ``randint`` / ``randperm``
  / ``normal`` / ``bernoulli`` / ``multinomial`` call, or an in-place
  ``.uniform_`` / ``.normal_``, without ``generator=``.
* ``host-sync-in-tick`` — the functions reachable, within their module,
  from the tick and decode functions (``TICK_ROOTS``: both sessions'
  ``_sliding_step`` and ``_sliding_step_compact``, ``core/online.py``
  ``_observe_impl``, ``drop_backfill`` (in ``kernels/ref.py``),
  ``regression/stream.py`` ``observe`` / ``evict_oldest``, the
  ``stream_update`` routing and wrapper, ``models/lm.py``
  ``decode_step``, the recurrent blocks' decode steps in
  ``models/recurrent.py``) must not call ``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``, ``np.asarray``,
  ``torch.cuda.synchronize``, a ``time`` function, or ``torch.as_tensor``
  / ``torch.tensor`` with ``device=`` (from a Python number or host data
  that is a copy from the host, which waits for the card): each waits for
  the card (or reads the host clock) once a tick, which a CUDA-graph
  capture of the tick cannot hold. The engine wrappers, which time operations by
  design, are not roots.
* ``tenant-python-loop`` — the engine modules (``serving/engine.py``,
  ``regression/engine.py``) must never loop in Python over the tenant
  axis: one launch of each kernel a tick for the whole batch.
* ``swallowed-exception`` — the durability layers (``serving/``,
  ``checkpoint/``, ``robustness/``) must never silently eat an error: a
  bare ``except:`` or a handler whose whole body is ``pass`` / ``...`` /
  ``continue`` hides the I/O failures the chaos tests inject.

The JAX lint's ``donate-inconsistent`` has no counterpart
(``NOT_PORTED``): the port does not donate buffers. Its contract, state
updated in place, is checked at run time by the audit's ``in-place``
checker.

Lines carrying ``# audit: allow`` are exempt (one escape hatch, visible
in review). Pure standard library.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass

_PRAGMA = "# audit: allow"

#: numpy.random constructors that take (or carry) an explicit seed —
#: everything else on the module-level RNG is an unkeyed draw
_KEYED_NP_RANDOM = {"default_rng", "RandomState", "Generator",
                    "SeedSequence", "PCG64", "Philox", "bit_generator"}

#: torch draws that take a ``generator=``; without one they use the
#: process-global generator
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial"}
_TORCH_INPLACE_DRAWS = {"uniform_", "normal_"}

_HOST_SYNC_ATTRS = {"item", "cpu", "tolist", "numpy"}
#: torch constructors that copy host data (a Python number included) to
#: the ``device=`` they are given
_HOST_COPY_CTORS = {"as_tensor", "tensor"}
_TIME_FNS = {"time", "perf_counter", "monotonic", "process_time",
             "time_ns", "perf_counter_ns", "monotonic_ns"}

#: the tick and decode functions, by module path under the package
TICK_ROOTS = {
    "serving/session.py": ("_sliding_step", "_sliding_step_compact"),
    "regression/session.py": ("_sliding_step", "_sliding_step_compact"),
    "core/online.py": ("_observe_impl",),
    "kernels/ref.py": ("drop_backfill",),  # core.online re-exports it
    "regression/stream.py": ("observe", "evict_oldest"),
    "kernels/ops.py": ("stream_update", "stream_tick"),
    "kernels/stream_update.py": ("stream_update",),
    "models/lm.py": ("decode_step",),
    "models/recurrent.py": ("rglru_block_step", "mlstm_block_step",
                            "slstm_block_step"),
}

#: modules whose For/While loops must not range over the tenant axis
_ENGINE_MODULES = ("serving/engine.py", "regression/engine.py")

#: layers where an except handler may not silently swallow the error
_SWALLOW_SCOPED = ("repro_torch/serving/", "repro_torch/checkpoint/",
                   "repro_torch/robustness/")

#: handler bodies that discard the exception without a trace
_SWALLOW_STMTS = (ast.Pass, ast.Continue)

RULE_NAMES = ("unkeyed-randomness", "host-sync-in-tick",
              "tenant-python-loop", "swallowed-exception")

#: JAX lint rules without a counterpart here, and why
NOT_PORTED = {
    "donate-inconsistent": "the port does not donate buffers; its "
                           "contract, state updated in place, is the "
                           "audit's in-place checker",
}


@dataclass
class Violation:
    rule: str
    path: str
    line: int
    message: str

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


def _allowed(src_lines: list, lineno: int) -> bool:
    if 1 <= lineno <= len(src_lines):
        return _PRAGMA in src_lines[lineno - 1]
    return False


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _attr_chain(node: ast.AST) -> list:
    """['np', 'random', 'default_rng'] for np.random.default_rng."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def _module_aliases(tree: ast.Module, module: str) -> set:
    """Names this module binds to ``module`` (np, numpy, torch, ...)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    out.add(a.asname or module)
    return out


def _reachable_from(roots, funcs: dict) -> set:
    """Transitive closure over same-module Name calls."""
    seen = set()
    todo = [r for r in roots if r in funcs]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for node in ast.walk(funcs[name]):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in funcs:
                todo.append(node.func.id)
    return seen


def _lint_randomness(path, tree, lines, out):
    np_names = _module_aliases(tree, "numpy")
    rnd_names = _module_aliases(tree, "random")
    torch_names = _module_aliases(tree, "torch")
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or _allowed(lines, node.lineno):
            continue
        chain = _attr_chain(node.func)
        keyed = any(kw.arg == "generator" for kw in node.keywords)
        if len(chain) >= 3 and chain[0] in np_names \
                and chain[1] == "random" \
                and chain[2] not in _KEYED_NP_RANDOM:
            out.append(Violation(
                "unkeyed-randomness", path, node.lineno,
                f"module-level numpy RNG draw {'.'.join(chain)}(); key it "
                f"via np.random.default_rng(seed)"))
        elif len(chain) == 2 and chain[0] in rnd_names:
            out.append(Violation(
                "unkeyed-randomness", path, node.lineno,
                f"stdlib random call {'.'.join(chain)}() uses "
                f"process-global state; use a keyed generator"))
        elif len(chain) == 2 and chain[0] in torch_names \
                and chain[1] in _TORCH_DRAWS and not keyed:
            out.append(Violation(
                "unkeyed-randomness", path, node.lineno,
                f"{'.'.join(chain)}() without generator= draws from the "
                f"process-global generator; pass a seeded "
                f"torch.Generator"))
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _TORCH_INPLACE_DRAWS and not keyed:
            out.append(Violation(
                "unkeyed-randomness", path, node.lineno,
                f".{node.func.attr}() without generator= draws from the "
                f"process-global generator; pass a seeded "
                f"torch.Generator"))


def _tick_roots(path: str) -> tuple:
    norm = _norm(path)
    for rel, roots in TICK_ROOTS.items():
        if norm.endswith("repro_torch/" + rel):
            return roots
    return ()


def _lint_host_sync(path, tree, lines, out):
    roots = _tick_roots(path)
    if not roots:
        return
    np_names = _module_aliases(tree, "numpy")
    torch_names = _module_aliases(tree, "torch")
    funcs = {n.name: n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for fname in sorted(_reachable_from(roots, funcs)):
        for node in ast.walk(funcs[fname]):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            bad = None
            if len(chain) == 2 and chain[0] == "time" \
                    and chain[1] in _TIME_FNS:
                bad = f"wall-clock read {'.'.join(chain)}()"
            elif chain[-2:] == ["cuda", "synchronize"]:
                bad = "torch.cuda.synchronize()"
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOST_SYNC_ATTRS:
                bad = f".{node.func.attr}() host read"
            elif len(chain) == 2 and chain[0] in np_names \
                    and chain[1] == "asarray":
                bad = "np.asarray (device->host transfer)"
            elif len(chain) == 2 and chain[0] in torch_names \
                    and chain[1] in _HOST_COPY_CTORS \
                    and any(kw.arg == "device" for kw in node.keywords):
                bad = (f"{'.'.join(chain)}(..., device=) (a host->device "
                       f"copy of a Python number or host data)")
            if bad and not _allowed(lines, node.lineno):
                out.append(Violation(
                    "host-sync-in-tick", path, node.lineno,
                    f"{bad} inside tick-reachable function {fname}()"))


def _lint_tenant_loops(path, tree, lines, out):
    if not _norm(path).endswith(_ENGINE_MODULES):
        return
    for node in ast.walk(tree):
        if not isinstance(node, (ast.For, ast.While)):
            continue
        probe = node.iter if isinstance(node, ast.For) else node.test
        names = {n.id for n in ast.walk(probe) if isinstance(n, ast.Name)}
        attrs = {n.attr for n in ast.walk(probe)
                 if isinstance(n, ast.Attribute)}
        if ("n_sessions" in names | attrs or "sessions" in names) \
                and not _allowed(lines, node.lineno):
            out.append(Violation(
                "tenant-python-loop", path, node.lineno,
                "Python loop over the tenant axis in an engine module; a "
                "tick is one launch of each kernel for every tenant"))


def _swallows(handler: ast.ExceptHandler) -> bool:
    """True when the handler body does nothing with the error."""
    for stmt in handler.body:
        if isinstance(stmt, _SWALLOW_STMTS):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(
                stmt.value, ast.Constant):  # `...` or a bare docstring
            continue
        return False
    return True


def _lint_swallowed(path, tree, lines, out):
    if not any(s in _norm(path) for s in _SWALLOW_SCOPED):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler) \
                or _allowed(lines, node.lineno):
            continue
        if node.type is None:
            out.append(Violation(
                "swallowed-exception", path, node.lineno,
                "bare except: in a durability layer catches "
                "KeyboardInterrupt/SystemExit and hides injected I/O "
                "faults; catch a concrete exception type"))
        elif _swallows(node):
            out.append(Violation(
                "swallowed-exception", path, node.lineno,
                "except handler silently discards the error; re-raise, "
                "record it, or fall back explicitly (# audit: allow to "
                "opt out)"))


_RULES = (_lint_randomness, _lint_host_sync, _lint_tenant_loops,
          _lint_swallowed)


def lint_paths(paths) -> list:
    """Run every rule over the given .py files; list of Violations."""
    out: list = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:  # surfaced, not swallowed
            out.append(Violation("parse-error", path, e.lineno or 0,
                                 str(e)))
            continue
        lines = src.splitlines()
        for rule in _RULES:
            rule(path, tree, lines, out)
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def lint_tree(root: str) -> list:
    """Lint every .py file under ``root`` (normally ``src/repro_torch``)."""
    paths = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                paths.append(os.path.join(dirpath, fn))
    return lint_paths(paths)


__all__ = ["Violation", "lint_paths", "lint_tree", "RULE_NAMES",
           "NOT_PORTED", "TICK_ROOTS"]
