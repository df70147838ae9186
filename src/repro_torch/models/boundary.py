"""The block boundary's cotangent rounding and layout.

Counterpart of ``repro/sharding/activation.py::grad_compressed_boundary``.
The reference's trainer runs its step under ``activation_mesh``, and there
every block's input passes a boundary that is the identity forward and
rounds the incoming cotangent to bf16 backward, then constrains it to the
boundary's own layout (``spec``: a reduce-scatter where the partitioner
would all-reduce); outside that context it is the identity both ways. In
the port the layout is a DTensor's: where the boundary's input is one,
the cotangent is redistributed to the placement ``spec`` resolves to
under the active ``activation_mesh``, taken in the forward pass.
``compressed_boundaries()`` is the port's context: the trainer runs its
steps inside it, and nothing else does, so the port's trainer computes
what the reference's does while a bare ``train_step_loss`` gradient (the
reference's without a mesh) is exact.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.sharding.activation import is_dtensor, target_placements

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_compressed_boundaries", default=False)


@contextlib.contextmanager
def compressed_boundaries():
    """Round block-boundary cotangents to bf16 inside this context."""
    token = _ACTIVE.set(True)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


class _RoundCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.bfloat16).to(g.dtype)
        if ctx.placements is not None and \
                tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def grad_compressed_boundary(x: torch.Tensor,
                             spec: tuple | None = None) -> torch.Tensor:
    """``x`` itself outside ``compressed_boundaries()``; inside it, ``x``
    forward with its cotangent rounded to bf16 (and back to ``x``'s
    dtype) on the way back, and for a DTensor ``x`` redistributed to
    ``spec``'s placement."""
    if not _ACTIVE.get() or not x.requires_grad:
        return x
    want = None
    if spec is not None and is_dtensor(x):
        want = target_placements(x, spec)
    return _RoundCotangent.apply(x, want)


__all__ = ["compressed_boundaries", "grad_compressed_boundary"]
