"""Engine states carried across, as numpy arrays.

The JAX classification engine's state is an 8-leaf pytree whose
``tree_flatten`` order is ``X, y, best, n, D, head, aid, wrap``
(``repro/serving/session.py`` and ``repro/core/online.py``); the
regression engine's is the 10-leaf ``X, y, D, nbr_d, nbr_y, n, head,
aid, wrap, nbr_a`` (``repro/regression/stream.py``). Each leaf has the
leading tenant axis. These functions move them into the port and back,
so both engines can start from one state and be compared leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.regression.stream import RegStreamState
from repro_torch.serving.session import Session

# dtype of each leaf in tree_flatten order; None keeps the float type
_LEAF_DTYPES = (None, torch.int32, None, torch.int32, None, torch.int32,
                torch.int32, torch.int32)
_REG_LEAF_DTYPES = (None, None, None, None, None, torch.int32, torch.int32,
                    torch.int32, torch.int32, torch.int32)


def _from_numpy(leaves, dtypes, names: str, device):
    if len(leaves) != len(dtypes):
        raise ValueError(f"expected {len(dtypes)} leaves ({names}), got "
                         f"{len(leaves)}")
    dev = resolve(device)
    return [torch.as_tensor(np.array(a), device=dev, dtype=dt)
            for a, dt in zip(leaves, dtypes)]


def session_from_numpy(leaves, device=None) -> Session:
    """Port state from the JAX engine's eight leaves (numpy arrays)."""
    return Session.from_leaves(_from_numpy(
        leaves, _LEAF_DTYPES, "X, y, best, n, D, head, aid, wrap", device))


def session_to_numpy(state: Session) -> list[np.ndarray]:
    """The eight leaves of ``state`` as numpy arrays, JAX order."""
    return [t.detach().cpu().numpy() for t in state.leaves()]


def reg_state_from_numpy(leaves, device=None) -> RegStreamState:
    """Port regression state from the JAX engine's ten leaves."""
    return RegStreamState.from_leaves(_from_numpy(
        leaves, _REG_LEAF_DTYPES,
        "X, y, D, nbr_d, nbr_y, n, head, aid, wrap, nbr_a", device))


def reg_state_to_numpy(state: RegStreamState) -> list[np.ndarray]:
    """The ten leaves of ``state`` as numpy arrays, JAX order."""
    return [t.detach().cpu().numpy() for t in state.leaves()]


__all__ = ["session_from_numpy", "session_to_numpy", "reg_state_from_numpy",
           "reg_state_to_numpy"]
