"""Activation placements, the port's copy of ``repro/sharding/
activation.py``.

The reference's model code calls ``constrain(x, (BATCH_AXES, None,
"model"))`` and launch code wraps tracing in ``activation_mesh(mesh)``,
which turns the calls into ``with_sharding_constraint``. In the port
``resolve_spec`` gives the placement the reference would pin, resolved
the same way: the ``BATCH_AXES`` sentinel becomes the active strategy's
batch axes, ``"model"`` entries drop under ``fsdp``, and axes missing
from the mesh or not dividing the dimension drop silently. Outside
``activation_mesh`` nothing resolves (the reference's no-op).

``constrain`` acts on a DTensor (a sharded program's activation, on the
``DeviceMesh`` given to ``activation_mesh``): it redistributes it to the
resolved placement (``sharding.rules.dtensor_placements``), which is
where the collectives the reference's partitioner inserts happen here (an
all-gather of the sequence, a reduce-scatter of a partial sum). On a
plain tensor, a one-process program that holds every tensor whole, it
returns ``x`` itself. ``replicated_like(t, x)`` makes a plain tensor
built from shapes (rotary tables, masks) a replicated DTensor beside a
DTensor ``x``, and is the identity otherwise.

The active mesh is process-wide, not a context variable: autograd runs a
checkpointed block's recomputation on its own device threads, and the
recomputed forward must constrain as the first did.

``grad_compressed_boundary`` (the block boundary's bf16 cotangent, pinned
to the boundary's layout) is ``models/boundary.py``'s, the port's
trainer's context.

Where the reference leaves a layout to XLA, DTensor's sharding
propagation would choose one op by op, and two PyTorch builds choose
differently (2.11 all-reduces a partial sum that 2.13 reduce-scatters,
and the cotangents follow). The model code pins those sites explicitly:
``reduce_partial`` (a partial sum reduce-scattered onto a dimension or
all-reduced, its gradient passed through), ``gather_dims`` and
``reshard`` (an all-gather, an all-to-all), and ``grad_like`` (a
cotangent brought to its tensor's own placement before the backward
takes it). ``launch/census_16x16.json`` records the program they give.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple

import torch

BATCH_AXES = ("pod", "data")  # sentinel resolved against the active strategy

_LOCK = threading.Lock()
_STACK: list = []


def _active():
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def activation_mesh(mesh, strategy: str = "tp_sp"):
    """Resolve activation placements against ``mesh`` (a
    ``core.distributed.Mesh`` or a ``DeviceMesh``; a sharded program's
    ``constrain`` needs the latter) inside this context.

    strategy:
      "tp_sp" — batch over (pod, data); tensor/sequence parallelism over
                "model" (Megatron-SP, the default);
      "fsdp"  — batch over (pod, data, model): pure ZeRO-3 data
                parallelism; every "model" entry resolves to None.
    """
    from repro_torch.sharding.rules import axis_sizes

    if strategy == "fsdp":
        batch_axes = ("pod", "data", "model")
        tensor_ok = False
    else:
        batch_axes = ("pod", "data")
        tensor_ok = True
    ctx = {"sizes": axis_sizes(mesh), "batch_axes": batch_axes,
           "tensor_ok": tensor_ok,
           "mesh": mesh if hasattr(mesh, "mesh_dim_names") else None}
    with _LOCK:
        _STACK.append(ctx)
    try:
        yield
    finally:
        with _LOCK:
            _STACK.remove(ctx)


def resolve_spec(shape: tuple, spec: tuple) -> tuple | None:
    """The placement ``constrain`` resolves for a tensor of ``shape``: one
    entry a dimension (None, an axis name, or a tuple of axes), or None
    where the reference pins nothing (no active mesh, or every entry
    dropped).

    Spec entries: None, an axis name, or a tuple of axes (sharded
    jointly). The BATCH_AXES sentinel resolves to the active strategy's
    batch axes; "model" entries are dropped under the fsdp strategy."""
    ctx = _active()
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


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def target_placements(x, spec: tuple):
    """The placements ``constrain(x, spec)`` moves the DTensor ``x`` to,
    or None without an active ``DeviceMesh``. Where every entry drops the
    reference pins nothing and leaves the layout to its partitioner; a
    DTensor program has none, so the entries' ``None`` holds: replicated
    (a sequence that cannot shard is gathered whole)."""
    ctx = _active()
    if ctx is None or ctx["mesh"] is None:
        return None
    resolved = resolve_spec(tuple(x.shape), spec) or (None,) * x.dim()
    from repro_torch.sharding.rules import dtensor_placements

    return dtensor_placements(resolved, ctx["mesh"])


def constrain(x, spec: tuple):
    """``x`` redistributed to ``target_placements(x, spec)`` when ``x`` is
    a DTensor under an active ``DeviceMesh``; ``x`` itself otherwise (a
    plain tensor is whole)."""
    if not is_dtensor(x):
        return x
    want = target_placements(x, spec)
    if want is None or tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _moved(x, want):
    want = tuple(want)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def placed_like(t, ref):
    """``t`` placed as the DTensor ``ref`` is (an explicit
    redistribution); ``t`` itself when ``ref`` is not a DTensor."""
    return _moved(t, ref.placements) if is_dtensor(ref) else t


class _Settle(torch.autograd.Function):
    """A partial sum made whole forward; the gradient passes through in
    the placement it arrives in (the same global value), as it does where
    DTensor resolves a partial operand inside an op. ``Redistribute``'s
    own backward would gather it to a replicated one."""

    @staticmethod
    def forward(ctx, x, want):
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_partial(x, target):
    """``x`` with each partial sum over a mesh dim made whole explicitly,
    its other placements kept: reduce-scattered onto tensor dimension
    ``target`` (an int), all-reduced where ``target`` is None, or placed on
    that mesh dim as ``constrain(x, target)`` would place it (a spec).
    The gradient passes through as it arrives (``_Settle``). ``x`` itself
    when it is not a DTensor or holds no partial sum. The sites where the
    reference leaves a partial sum to XLA call it before the first op
    that cannot take one: left to DTensor, the choice between the two
    collectives (and the dimension scattered onto) depends on the PyTorch
    build."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate, Shard

    if isinstance(target, tuple):
        to = target_placements(x, target)
    else:
        to = (Replicate() if target is None else Shard(target),) \
            * x.device_mesh.ndim
    want = tuple(t if p.is_partial() else p
                 for p, t in zip(x.placements, to))
    return _Settle.apply(x, want)


class _GradLike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def grad_like(x):
    """``x`` forward, its cotangent redistributed to ``x``'s own placement
    on the way back (a reduce-scatter of a partial sum onto ``x``'s
    shards, explicitly); ``x`` itself when it is not a DTensor or needs no
    gradient. Where a cotangent would reach an op that cannot take its
    placement, DTensor's choice of where and how to redistribute it
    depends on the PyTorch build."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    return _GradLike.apply(x)


def gather_dims(x, dims: tuple):
    """``x`` whole along tensor dimensions ``dims``: each mesh dim that
    shards one of them gathered (an all-gather), the rest kept; ``x``
    itself when it is not a DTensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return _moved(x, (Replicate() if any(p.is_shard(d) for d in dims)
                      else p for p in x.placements))


def reshard(x, src: int, dst: int):
    """``x`` with each mesh dim that shards tensor dimension ``src``
    sharding ``dst`` instead (an all-to-all); ``x`` itself when it is not
    a DTensor."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard

    return _moved(x, (Shard(dst) if p.is_shard(src) else p
                      for p in x.placements))


def mesh_size(axis: str) -> int:
    """The size of mesh axis ``axis`` under the active ``activation_mesh``
    (1 without one, or where the mesh has no such axis)."""
    ctx = _active()
    return 1 if ctx is None else ctx["sizes"].get(axis, 1)


def gathered(w, dims: tuple = ()):
    """A sharded program's weight ready to compute with: whole over the
    data axes (``pod``, ``data``; the FSDP all-gather, whose gradient is
    the reduce-scatter back to the weight's placement) and over tensor
    dimensions ``dims``; ``w`` itself when it is not a DTensor."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if p.is_shard() and (
        names[i] in ("pod", "data") or p.dim in dims) else p
        for i, p in enumerate(w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def replicated_like(t, x):
    """``t``, a plain tensor every rank computes whole, as a replicated
    DTensor on ``x``'s mesh when ``x`` is a DTensor; ``t`` otherwise."""
    if not is_dtensor(x) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def unflatten_last(t, sizes: tuple):
    """``t`` with its last dimension split into ``sizes`` (a reshape). A
    DTensor whose last dimension is sharded over mesh dims that
    ``sizes[0]`` does not divide over is first made whole along it:
    DTensor cannot carry such a shard into the new dimensions (4 heads of
    a 16-way sharded projection)."""
    shape = tuple(t.shape[:-1]) + tuple(sizes)
    if is_dtensor(t):
        last = t.dim() - 1
        n = math.prod(t.device_mesh.size(i) for i, p in
                      enumerate(t.placements) if p.is_shard(last))
        if sizes[0] % n:
            from torch.distributed.tensor import Replicate

            t = t.redistribute(t.device_mesh, tuple(
                Replicate() if p.is_shard(last) else p
                for p in t.placements))
    return t.reshape(shape)


def dispatch_groups() -> int:
    """The MoE's dispatch groups: the product of the active mesh's
    ``pod`` and ``data`` sizes, 1 without an active mesh (the reference's
    ``_dispatch_groups``)."""
    ctx = _active()
    if ctx is None:
        return 1
    return math.prod(ctx["sizes"][a] for a in ("pod", "data")
                     if a in ctx["sizes"])


class Out(NamedTuple):
    """How ``on_blocks`` places one result: like argument ``arg``, result
    dimension ``j`` sharded where that argument's dimension ``dims[j]`` is
    (None: a dimension no argument's placement carries). ``partial``: a
    mesh dim the work splits over that no carried dimension shards holds
    a partial sum there (each rank's block of a sum over a split
    dimension); without it such a mesh dim raises."""

    arg: int
    dims: tuple
    partial: bool = False


def on_blocks(fn, args: tuple, specs: tuple, outs: tuple):
    """``fn(*args)`` computed on each rank's own blocks of the DTensor
    arguments, its results DTensors placed by ``outs`` (one ``Out`` a
    result; None passes a result through); ``fn(*args)`` itself when no
    argument is a DTensor (a one-process program).

    ``specs`` has one entry an argument: a spec that the DTensor is first
    ``constrain``ed to, or None (a DTensor as it is placed, anything else
    passed through). ``fn`` sees plain tensors and makes whatever plain
    tensors it needs (masks, zero states) itself; nothing it does
    communicates.

    Gradients: an argument sharded on a mesh dim takes its gradient
    sharded the same way; a partial sum takes a replicated one; a
    replicated argument takes a partial sum on every mesh dim the work
    splits over (some argument is sharded or partial there: each rank's
    block contributes its own share) and a replicated gradient elsewhere
    (every rank computed the same thing)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    placed = [constrain(a, s) if s is not None and is_dtensor(a) else a
              for a, s in zip(args, specs)]
    dts = [a for a in placed if is_dtensor(a)]
    mesh = dts[0].device_mesh
    split = {i for a in dts for i, p in enumerate(a.placements)
             if not p.is_replicate()}
    local = []
    for a in placed:
        if not is_dtensor(a):
            local.append(a)
            continue
        grad = tuple(Replicate() if p.is_partial() else
                     Partial() if p.is_replicate() and i in split else p
                     for i, p in enumerate(a.placements))
        local.append(a.to_local(grad_placements=grad))
    res = fn(*local)
    single = not isinstance(res, tuple)
    wrapped = []
    for t, o in zip((res,) if single else res, outs):
        if o is None:
            wrapped.append(t)
            continue
        want = []
        for i, p in enumerate(placed[o.arg].placements):
            if p.is_shard() and p.dim in o.dims:
                want.append(Shard(o.dims.index(p.dim)))
            elif i not in split:
                want.append(Replicate())
            elif o.partial:
                want.append(Partial())
            else:
                raise ValueError(
                    f"on_blocks: result {len(wrapped)} carries no dimension "
                    f"mesh dim {i} ({mesh.mesh_dim_names[i]}) splits the "
                    "work over, and is not marked partial")
        wrapped.append(DTensor.from_local(t, mesh, tuple(want),
                                          run_check=False))
    return wrapped[0] if single else tuple(wrapped)


__all__ = ["constrain", "activation_mesh", "resolve_spec", "BATCH_AXES",
           "is_dtensor", "target_placements", "replicated_like",
           "gathered", "dispatch_groups", "on_blocks", "Out",
           "unflatten_last", "reduce_partial", "gather_dims", "reshard",
           "mesh_size", "grad_like", "placed_like"]
