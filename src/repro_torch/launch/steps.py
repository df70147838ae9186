"""The train step, the port's copy of ``repro/launch/steps.py::
make_train_step`` on one card.

Gradients are the loss's ``backward()`` (the parameters must require a
gradient: ``params.requires_grad_(True)``); with ``microbatches > 1`` the
batch is cut into equal slices along its first axis, each slice's
gradients added into an f32 accumulator, and the sums and the loss divided
by the count; then the clip and AdamW (``optim.apply_updates``). The
reference's mesh branch (gradients constrained to the parameters'
sharding) and its lowering helpers have no counterpart: a ``mesh``
raises.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.optim import OptimizerConfig, apply_updates


def _grads(params) -> dict:
    """Each parameter's gradient (zeros where none reached it), and the
    parameters' ``.grad`` cleared."""
    out = {}
    for name, p in params.named_parameters():
        out[name] = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
    return out


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig,
                    microbatches: int = 1, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "lr", "grad_norm", "step"})``; ``params`` (an ``LmParams``
    that requires grad) is updated in place, ``batch`` is a dict of
    tensors on its device."""
    if mesh is not None:
        raise ValueError("the port trains on one device: no mesh")
    if microbatches < 1:
        raise ValueError(f"microbatches {microbatches} < 1")

    def grads_of(params, batch):
        loss = lm.train_step_loss(params, cfg, batch)
        loss.backward()
        return loss.detach(), _grads(params)

    def train_step(params, opt_state, batch):
        if not any(p.requires_grad for p in params.parameters()):
            raise ValueError("params require no gradient: call "
                             "params.requires_grad_(True) first")
        if microbatches == 1:
            loss, grads = grads_of(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"{microbatches} microbatches")
            b = B // microbatches
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(grads.values())).device)
            for i in range(microbatches):
                mb = {k: t[i * b:(i + 1) * b] for k, t in batch.items()}
                l, g = grads_of(params, mb)
                loss = loss + l
                for n, t in g.items():
                    grads[n].add_(t.float())
                del g
            loss = loss / microbatches
            grads = {n: t / microbatches for n, t in grads.items()}
        params, opt_state, stats = apply_updates(params, grads, opt_state,
                                                 opt_cfg)
        return params, opt_state, {"loss": loss, **stats}

    return train_step


__all__ = ["make_train_step"]
