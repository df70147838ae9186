"""Gated feed-forward layer (SwiGLU / GeGLU).

Counterpart of the dense part of ``repro/models/mlp.py``; the
mixture-of-experts layers are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import act_fn, dense_init, frozen


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype) -> nn.ParameterDict:
    return frozen({
        "w_gate": dense_init((d_model, d_ff), dtype, generator),
        "w_up": dense_init((d_model, d_ff), dtype, generator),
        "w_down": dense_init((d_ff, d_model), dtype, generator),
    })


def mlp(p, x, act: str = "silu"):
    g = act_fn(act)(torch.einsum("bsd,df->bsf", x, p["w_gate"]))
    u = torch.einsum("bsd,df->bsf", x, p["w_up"])
    return torch.einsum("bsf,fd->bsd", g * u, p["w_down"])


__all__ = ["init_mlp", "mlp"]
