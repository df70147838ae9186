"""Mesh construction, counterpart of ``repro/launch/mesh.py``.

A ``core.distributed.Mesh`` is a grid of ``torch.device``s with axis
names; building one touches no device state beyond counting the visible
cards. ``make_production_mesh`` (the reference's 16 x 16 and 2 x 16 x 16
meshes of the 512-device dry run) is not here: it comes with the dry-run
slice (``launch/dryrun.py``, ``sharding/``), which builds each
architecture on the ``meta`` device instead of on placeholder devices.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.distributed import Mesh, make_mesh as _grid
from repro_torch.core.distributed import visible_devices


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A ``shape`` mesh with axis names ``axes`` over ``devices`` (default:
    the visible cards, which must number at least ``prod(shape)``; an
    explicit list may repeat a device)."""
    devs = visible_devices() if devices is None else list(devices)
    return _grid(shape, axes, devs)


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


__all__ = ["make_mesh", "make_host_mesh"]
