"""Activation placements, the port's copy of ``repro/sharding/
activation.py``.

The reference's model code calls ``constrain(x, (BATCH_AXES, None,
"model"))`` and launch code wraps tracing in ``activation_mesh(mesh)``,
which turns the calls into ``with_sharding_constraint``. The port runs in
one process that holds every tensor whole, so ``constrain`` returns ``x``
itself; ``resolve_spec`` gives the placement the reference would pin,
resolved the same way: the ``BATCH_AXES`` sentinel becomes the active
strategy's batch axes, ``"model"`` entries drop under ``fsdp``, and axes
missing from the mesh or not dividing the dimension drop silently.
Outside ``activation_mesh`` nothing resolves (the reference's no-op).

The reference's ``grad_compressed_boundary`` (the block boundary's bf16
cotangent) is ``models/boundary.py``'s, the port's trainer's context.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

BATCH_AXES = ("pod", "data")  # sentinel resolved against the active strategy

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_activation_mesh", default=None)


@contextlib.contextmanager
def activation_mesh(mesh, strategy: str = "tp_sp"):
    """Resolve activation placements against ``mesh`` inside this context.

    strategy:
      "tp_sp" — batch over (pod, data); tensor/sequence parallelism over
                "model" (Megatron-SP, the default);
      "fsdp"  — batch over (pod, data, model): pure ZeRO-3 data
                parallelism; every "model" entry resolves to None.
    """
    if strategy == "fsdp":
        batch_axes = ("pod", "data", "model")
        tensor_ok = False
    else:
        batch_axes = ("pod", "data")
        tensor_ok = True
    token = _ACTIVE.set({
        "sizes": {a: int(mesh.shape[a]) for a in mesh.axis_names},
        "batch_axes": batch_axes,
        "tensor_ok": tensor_ok,
    })
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def resolve_spec(shape: tuple, spec: tuple) -> tuple | None:
    """The placement ``constrain`` resolves for a tensor of ``shape``: one
    entry a dimension (None, an axis name, or a tuple of axes), or None
    where the reference pins nothing (no active mesh, or every entry
    dropped).

    Spec entries: None, an axis name, or a tuple of axes (sharded
    jointly). The BATCH_AXES sentinel resolves to the active strategy's
    batch axes; "model" entries are dropped under the fsdp strategy."""
    ctx = _ACTIVE.get()
    if ctx is None:
        return None
    axis_sizes = ctx["sizes"]
    entries = []
    for dim, want in zip(shape, spec):
        if want is None:
            entries.append(None)
            continue
        cands = want if isinstance(want, tuple) else (want,)
        if cands == BATCH_AXES:
            cands = ctx["batch_axes"]
        elif not ctx["tensor_ok"] and "model" in cands:
            cands = tuple(a for a in cands if a != "model")
        axes = tuple(a for a in cands if a in axis_sizes)
        size = math.prod(axis_sizes[a] for a in axes) if axes else 1
        if axes and size > 1 and dim % size == 0:
            entries.append(axes if len(axes) > 1 else axes[0])
        else:
            entries.append(None)
    if all(e is None for e in entries):
        return None
    return tuple(entries)


def constrain(x, spec: tuple):
    """``x`` itself: the port holds every tensor whole. Its placement under
    the active mesh is ``resolve_spec(x.shape, spec)``."""
    return x


__all__ = ["constrain", "activation_mesh", "resolve_spec", "BATCH_AXES"]
