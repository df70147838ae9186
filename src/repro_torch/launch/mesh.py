"""Mesh construction, counterpart of ``repro/launch/mesh.py``.

A ``core.distributed.Mesh`` is a grid of ``torch.device``s with axis
names; building one touches no device state beyond counting the visible
cards. ``make_production_mesh`` gives the reference's 16 x 16 and 2 x 16 x
16 meshes of the dry run (``launch/dryrun.py``) over the ``meta`` device
repeated, where the reference uses 512 placeholder XLA host devices: the
dry run reads only their axis names and sizes, and builds each
architecture on ``meta``.
"""
from __future__ import annotations

import numpy as np
import torch

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
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
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


__all__ = ["make_mesh", "make_production_mesh", "make_host_mesh"]
