"""The block boundary's cotangent rounding, on one device.

Counterpart of ``repro/sharding/activation.py::grad_compressed_boundary``
without its sharding constraint (the port runs on one card). The
reference's trainer runs its step under ``activation_mesh``, and there
every block's input passes a boundary that is the identity forward and
rounds the incoming cotangent to bf16 backward; outside that context it
is the identity both ways. ``compressed_boundaries()`` is the port's
context: the trainer runs its steps inside it, and nothing else does, so
the port's trainer computes what the reference's does while a bare
``train_step_loss`` gradient (the reference's without a mesh) is exact.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

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
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def grad_compressed_boundary(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself outside ``compressed_boundaries()``; inside it, ``x``
    forward with its cotangent rounded to bf16 (and back to ``x``'s
    dtype) on the way back."""
    if not _ACTIVE.get() or not x.requires_grad:
        return x
    return _RoundCotangent.apply(x)


__all__ = ["compressed_boundaries", "grad_compressed_boundary"]
