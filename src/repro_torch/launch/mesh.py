"""Mesh construction, counterpart of ``repro/launch/mesh.py``.

A ``core.distributed.Mesh`` is a grid of ``torch.device``s with axis
names; building one touches no device state beyond counting the visible
cards. ``make_production_mesh`` gives the reference's 16 x 16 and 2 x 16 x
16 meshes of the dry run (``launch/dryrun.py``) over the ``meta`` device
repeated, where the reference uses 512 placeholder XLA host devices: the
dry run reads only their axis names and sizes, and builds each
architecture on ``meta``.

The sharded programs run one process a device over a
``torch.distributed`` process group, and their mesh is a
``torch.distributed.DeviceMesh`` with the same axis names and sizes:
``device_mesh(mesh)`` turns a ``Mesh`` into one over the current group
(``init_group`` starts it: gloo on the CPU, NCCL on the cards, the
rendezvous a ``FileStore``). ``fake_device_mesh`` is the dry run's form:
a fake process group of ``prod(shape)`` ranks, this process rank 0, whose
collectives move nothing, so that a DTensor program on ``meta`` tensors
runs rank 0's share of the step with its collectives visible (the
counterpart of compiling over 512 placeholder XLA devices).
``make_production_device_mesh`` is the 16 x 16 or 2 x 16 x 16 mesh in
that form.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import Mesh, make_mesh as _grid
from repro_torch.core.distributed import visible_devices


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A ``shape`` mesh with axis names ``axes`` over ``devices`` (default:
    the visible cards, which must number at least ``prod(shape)``; an
    explicit list may repeat a device)."""
    devs = visible_devices() if devices is None else list(devices)
    return _grid(shape, axes, devs)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 devices) or 2x16x16 two-pod (512 devices)
    mesh, every entry the ``meta`` device."""
    shape, axes = production_shape(multi_pod)
    return _grid(shape, axes, [torch.device("meta")] * int(np.prod(shape)))


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A small ``("data", "model")`` mesh over whatever devices exist
    (``device``'s kind: the visible cards, or the one CPU device): the
    axes shrink to fit, as the reference's do."""
    devs = visible_devices(device)
    n = len(devs)
    data = min(data, n)
    model = max(1, min(model, n // data))
    return _grid((data, model), ("data", "model"),
                 devs[:int(np.prod((data, model)))])


def production_shape(multi_pod: bool = False) -> tuple:
    """``(shape, axes)`` of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _quiet_dtensor() -> None:
    """DTensor warns at every multi-dim redistribution it splits into
    several collectives and at gloo's all-to-all fallback; the census
    counts what it does instead."""
    import logging

    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)


# how long a rank waits in a collective or the rendezvous before failing
GROUP_TIMEOUT_S = 600.0


def init_group(rank: int, world: int, store_dir: str,
               device_type: str) -> None:
    """Join a ``world``-process group as ``rank`` (gloo for ``cpu``, NCCL
    for ``cuda``, where rank ``r`` takes card ``r``), the rendezvous a
    ``FileStore`` in ``store_dir`` (no TCP port to collide)."""
    import datetime

    _quiet_dtensor()
    os.makedirs(store_dir, exist_ok=True)
    store = dist.FileStore(os.path.join(store_dir, "rendezvous"), world)
    backend = "nccl" if device_type == "cuda" else "gloo"
    kw = {}
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S), **kw)


def device_mesh(mesh: Mesh):
    """``mesh`` as a ``DeviceMesh`` over the current process group (one
    process a device, ``dist.get_world_size() == mesh.size``), its device
    type ``mesh``'s, its axes and sizes ``mesh``'s."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise ValueError("device_mesh needs a process group: init_group "
                         "first")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"a {tuple(mesh.shape.values())} mesh needs "
                         f"{mesh.size} processes, the group has "
                         f"{dist.get_world_size()}")
    kind = mesh.flat()[0].type
    ranks = torch.arange(mesh.size).reshape(mesh.devices.shape)
    return DeviceMesh(kind, ranks, mesh_dim_names=tuple(mesh.axis_names))


def fake_device_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over a fake process group of
    ``prod(shape)`` ranks, this process rank 0 (a group already started
    in this process is replaced unless it is a fake one of that size).
    Its collectives move nothing; DTensors on it hold ``meta`` local
    tensors. ``device_type`` picks DTensor's collective forms: ``cuda``
    the cards' (all-to-all), ``cpu`` gloo's (all-gather and a slice in
    its place)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    _quiet_dtensor()
    shape, axes, n = tuple(shape), tuple(axes), int(np.prod(shape))
    if not (dist.is_initialized() and dist.get_backend() == "fake"
            and dist.get_world_size() == n):
        if dist.is_initialized():
            dist.destroy_process_group()
        _FAKE_MESHES.clear()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    key = (shape, axes, device_type)
    if key not in _FAKE_MESHES:
        _FAKE_MESHES[key] = DeviceMesh(device_type,
                                       torch.arange(n).reshape(shape),
                                       mesh_dim_names=axes)
    return _FAKE_MESHES[key]


_FAKE_MESHES: dict = {}


def make_production_device_mesh(*, multi_pod: bool = False):
    """The production mesh over a fake group of 256 or 512 ranks
    (``fake_device_mesh``, the cards' collective forms)."""
    return fake_device_mesh(*production_shape(multi_pod), "cuda")


__all__ = ["make_mesh", "make_production_mesh", "make_host_mesh",
           "production_shape", "init_group", "device_mesh",
           "fake_device_mesh", "make_production_device_mesh"]
