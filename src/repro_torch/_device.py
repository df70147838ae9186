"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for another
device. A request for ``cuda`` on a machine without a visible GPU raises:
the port never falls back to the CPU on its own.
"""
from __future__ import annotations

import numpy as np
import torch

BIG = 1e30  # inert-row sentinel, the same value as repro.core.online.BIG


def resolve(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the "
            "plain PyTorch path explicitly")
    return dev


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (array-like or tensor) as a contiguous ``dtype`` tensor on
    ``device``: float inputs become float32 and labels int32 at the
    entry points, as ``jnp.asarray`` does without x64."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=device).contiguous()
