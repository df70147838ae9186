"""Classification engine state carried across, as numpy arrays.

The JAX engine's state is an 8-leaf pytree whose ``tree_flatten`` order is
``X, y, best, n, D, head, aid, wrap`` (``repro/serving/session.py`` and
``repro/core/online.py``), each with the leading tenant axis. These two
functions move it into the port and back, so both engines can start from
one state and be compared leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.serving.session import Session

# dtype of each leaf in tree_flatten order; None keeps the float type
_LEAF_DTYPES = (None, torch.int32, None, torch.int32, None, torch.int32,
                torch.int32, torch.int32)


def session_from_numpy(leaves, device=None) -> Session:
    """Port state from the JAX engine's eight leaves (numpy arrays)."""
    if len(leaves) != len(_LEAF_DTYPES):
        raise ValueError(f"expected 8 leaves (X, y, best, n, D, head, aid, "
                         f"wrap), got {len(leaves)}")
    dev = resolve(device)
    return Session.from_leaves([
        torch.as_tensor(np.array(a), device=dev, dtype=dt)
        for a, dt in zip(leaves, _LEAF_DTYPES)])


def session_to_numpy(state: Session) -> list[np.ndarray]:
    """The eight leaves of ``state`` as numpy arrays, JAX order."""
    return [t.detach().cpu().numpy() for t in state.leaves()]


__all__ = ["session_from_numpy", "session_to_numpy"]
