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


def row_blocks(total: int, per: int, elems: int):
    """``(start, stop)`` of row blocks of at most ``elems`` elements when
    each of ``total`` rows has ``per``: how the batch paths bound the
    memory of their ``(rows, n)`` blocks."""
    step = max(1, elems // max(per, 1))
    for r0 in range(0, total, step):
        yield r0, min(r0 + step, total)


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (array-like or tensor) as a contiguous ``dtype`` tensor on
    ``device``: float inputs become float32 and labels int32 at the
    entry points, as ``jnp.asarray`` does without x64."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=device).contiguous()
