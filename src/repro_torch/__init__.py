"""PyTorch/CUDA port of the conformal-prediction serving stack.

Mirrors ``repro``'s layout (``kernels``, ``core``, ``serving``,
``launch``). It imports ``torch`` and ``numpy`` only; nothing of JAX and
nothing of the ``repro`` package. Entry points default to ``cuda`` and
raise when no GPU is visible (``device="cpu"`` selects the plain PyTorch
path, which the CPU tests use).
"""
from repro_torch._device import BIG, resolve

__all__ = ["BIG", "resolve"]
