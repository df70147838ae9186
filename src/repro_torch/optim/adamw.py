"""AdamW with an optional factored second moment, the port's copy of
``repro/optim/adamw.py``.

The state mirrors the parameters' leaves: ``mu`` and ``nu`` map each
leaf's dotted name to its first moment and to ``{"full"}`` or, for a
factored leaf, ``{"row", "col"}``; ``step`` is an int32 device scalar.
A model's leaves are the reference's (``LmParams.reference_leaves()``):
the layers of a run stacked on a leading axis, as the reference stacks
them, so that the decoupled decay (leaves of two or more dimensions: a
run's norm weights and biases too) and the factoring (both last dims at
least 8: a run's 1-D leaves once it has 8 layers) fall on the same
leaves; any other module's leaves are its named parameters, a plain dict
its tensors. The update is taken in f32 and cast to the parameter's
dtype, written into the parameters in place. Plain PyTorch: the
reference has no kernel here.

A sharded program's leaves are DTensors (``sharding.rules``): the
moments are placed like their parameters and the gradients arrive placed
so too (``launch/steps.py``), so a full-moment update runs on each rank's
blocks in the reference's order of operations, elementwise, and writes
the parameters' blocks in place. ``global_norm`` sums each rank's blocks'
squares (a leaf a rank holds a copy of counts on one rank only) and
all-reduces the total once: the clip's one reduction. A factored moment's
means cross blocks, so it runs through DTensor's ops.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    end_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    factored: bool = False  # factored 2nd moment for >=2D params
    moment_dtype: torch.dtype = torch.float32


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``end_lr``, in f32; ``step``
    an int or a tensor."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.end_lr + 0.5 * (cfg.peak_lr - cfg.end_lr) * (
        1.0 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def param_leaves(params) -> dict:
    """``{name: tensor or list of tensors}``: ``params.reference_leaves()``
    where it has them (a list is one leaf, its members stacked), else the
    named parameters of a module or the items of a dict."""
    if hasattr(params, "reference_leaves"):
        return params.reference_leaves()
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _shape(leaf) -> tuple:
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def _stacked(leaf) -> torch.Tensor:
    return torch.stack(leaf) if isinstance(leaf, list) else leaf


def _dt(leaf):
    """The DTensor behind a leaf (a stacked leaf's first layer), or
    None."""
    from torch.distributed.tensor import DTensor

    t = leaf[0] if isinstance(leaf, list) else leaf
    return t if isinstance(t, DTensor) else None


def _placed(leaf) -> tuple:
    """A DTensor leaf's placements; a stacked leaf's shard dims move one
    up, as the stacked tensor's."""
    from torch.distributed.tensor import Shard

    out = _dt(leaf).placements
    if isinstance(leaf, list):
        out = [Shard(p.dim + 1) if p.is_shard() else p for p in out]
    return tuple(out)


def _local(leaf) -> torch.Tensor:
    """This rank's block of a DTensor leaf (a stacked leaf's layers'
    blocks stacked)."""
    if isinstance(leaf, list):
        return torch.stack([t.to_local() for t in leaf])
    return leaf.to_local()


def _owned(dt) -> bool:
    """Whether this rank counts a DTensor's block in a sum over ranks: it
    sits at coordinate 0 of every mesh dim the tensor is replicated
    over."""
    mesh = dt.device_mesh
    return all(mesh.get_local_rank(i) == 0
               for i, p in enumerate(dt.placements) if p.is_replicate())


def init_opt_state(params, cfg: OptimizerConfig) -> dict:
    mu, nu = {}, {}
    for name, leaf in param_leaves(params).items():
        shape = _shape(leaf)
        dev = (leaf[0] if isinstance(leaf, list) else leaf).device
        zeros = lambda s: torch.zeros(s, dtype=cfg.moment_dtype,  # noqa: E731
                                      device=dev)
        mu[name] = zeros(shape)
        nu[name] = ({"row": zeros(shape[:-1]),
                     "col": zeros(shape[:-2] + shape[-1:])}
                    if cfg.factored and _factorable(shape)
                    else {"full": zeros(shape)})
    step = torch.zeros((), dtype=torch.int32,
                       device=next(iter(mu.values())).device)
    return {"mu": mu, "nu": nu, "step": step}


def global_norm(grads: dict) -> torch.Tensor:
    """``sqrt`` of the f32 sum of squares over the leaves, in order. Over
    DTensor leaves each rank sums its blocks' squares (a replicated block
    on one rank only) and one all-reduce adds the ranks' totals; the
    result is a plain tensor, the same on every rank."""
    first = _dt(next(iter(grads.values())))
    if first is None:
        total = 0
        for g in grads.values():
            total = total + torch.sum(torch.square(_stacked(g).float()))
        return torch.sqrt(total)
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    total = torch.zeros((), dtype=torch.float32,
                        device=first.to_local().device)
    for g in grads.values():
        if _owned(_dt(g)):
            total = total + torch.sum(torch.square(_local(g).float()))
    if first.device_mesh.size() > 1:
        total = funcol.wait_tensor(
            funcol.all_reduce(total, "sum", dist.group.WORLD))
    return torch.sqrt(total)


def leaf_grads(params, grads) -> dict:
    """The gradients of ``param_leaves(params)`` from ``grads`` (a
    tensor a parameter, keyed by the module's parameter names); a leaf
    of stacked layers gets the list of theirs."""
    by_id = {id(p): grads[n] for n, p in params.named_parameters()} \
        if isinstance(params, torch.nn.Module) else None
    out = {}
    for name, leaf in param_leaves(params).items():
        if isinstance(leaf, list):
            out[name] = [by_id[id(t)] for t in leaf]
        else:
            out[name] = grads[name] if by_id is None else by_id[id(leaf)]
    return out


@torch.no_grad()
def apply_updates(params, grads, opt_state: dict, cfg: OptimizerConfig):
    """One AdamW / factored-Adam step. ``grads`` maps each of the
    module's parameter names (a dict's keys) to its gradient. Writes the
    new parameters into ``params`` and returns ``(params, opt_state,
    stats)``, ``stats`` the step's ``lr``, ``grad_norm`` and ``step``."""
    step = opt_state["step"]
    step_dt = _dt(step)
    step = (step if step_dt is None else step_dt.to_local()) + 1
    lr = lr_schedule(cfg, step)
    gl = leaf_grads(params, grads)
    gnorm = global_norm(gl)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    c1 = 1.0 - torch.pow(cfg.b1, step.float())
    c2 = 1.0 - torch.pow(cfg.b2, step.float())

    mu, nu = {}, {}
    for name, leaf in param_leaves(params).items():
        m, v = opt_state["mu"][name], opt_state["nu"][name]
        local = _dt(leaf) is not None and _dt(m) is not None and \
            "full" in v and \
            _placed(leaf) == _placed(gl[name]) == m.placements \
            == v["full"].placements
        if local:
            _update_local(leaf, gl[name], m, v, name, scale, lr, c1, c2,
                          cfg, mu, nu)
            continue
        p = _stacked(leaf)
        if "full" in v:
            p_new, mu[name], v_full = _full_step(
                p, _stacked(gl[name]), m, v["full"], scale, lr, c1, c2, cfg)
            nu[name] = {"full": v_full}
        else:
            g = _stacked(gl[name]).float() * scale
            m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
            row = cfg.b2 * v["row"].float() \
                + (1 - cfg.b2) * torch.mean(g * g, dim=-1)
            col = cfg.b2 * v["col"].float() \
                + (1 - cfg.b2) * torch.mean(g * g, dim=-2)
            v_new = {"row": row, "col": col}
            # rank-1 reconstruction: v ~ row x col / mean(row)
            denom = torch.clamp(torch.mean(row, dim=-1, keepdim=True),
                                min=1e-30)
            v_hat = (row[..., None] * col[..., None, :]
                     / denom[..., None]) / c2
            update = (m_new / c1) / (torch.sqrt(v_hat) + cfg.eps)
            if p.dim() >= 2:  # decoupled weight decay on matrices only
                update = update + cfg.weight_decay * p.float()
            p_new = (p.float() - lr * update).to(p.dtype)
            mu[name] = m_new.to(m.dtype)
            nu[name] = {k: v_new[k].to(v[k].dtype) for k in v}
        if isinstance(leaf, list):
            for t, new in zip(leaf, p_new.unbind(0)):
                t.copy_(new)
        else:
            leaf.copy_(p_new)
    stats = {"lr": lr, "grad_norm": gnorm, "step": step}
    if step_dt is not None:
        from torch.distributed.tensor import DTensor

        step = DTensor.from_local(step, step_dt.device_mesh,
                                  step_dt.placements, run_check=False)
    return params, {"mu": mu, "nu": nu, "step": step}, stats


def _update_local(leaf, g_leaf, m, v, name, scale, lr, c1, c2, cfg, mu,
                  nu) -> None:
    """``apply_updates``' full-moment step on this rank's blocks of one
    DTensor leaf, in its order of operations: the parameters' blocks are
    written in place, the new moments go into ``mu`` / ``nu`` as DTensors
    placed as the old."""
    from torch.distributed.tensor import DTensor

    p = _local(leaf)
    p_new, m_new, v_new = _full_step(p, _local(g_leaf), m.to_local(),
                                     v["full"].to_local(), scale, lr, c1,
                                     c2, cfg)
    if isinstance(leaf, list):
        for t, new in zip(leaf, p_new.unbind(0)):
            t.to_local().copy_(new)
    else:
        leaf.to_local().copy_(p_new)

    def like(t, old):
        return DTensor.from_local(t, old.device_mesh, old.placements,
                                  run_check=False, shape=old.shape,
                                  stride=old.stride())

    mu[name] = like(m_new, m)
    nu[name] = {"full": like(v_new, v["full"])}


# the most elements an f32 temporary of a leaf's update holds: a larger
# leaf updates in slices of its flattened elements (an elementwise step
# gives each element the same bits in any slice)
_STEP_ELEMS = 1 << 26


def _full_step(p, g, m, v, scale, lr, c1, c2, cfg):
    """The full-moment AdamW step of one leaf, elementwise in the
    reference's order of operations: ``p`` the parameters, ``g`` their
    gradient, ``m`` and ``v`` the moments. Returns ``(p_new, m_new,
    v_new)`` in the dtypes of ``p``, ``m`` and ``v``, computed
    ``_STEP_ELEMS`` elements at a time (the embedding's or an expert
    stack's f32 temporaries would otherwise outgrow the state itself)."""
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in (p, m, v)]
    pf, gf, mf, vf, pn, mn, vn = (t.reshape(-1)
                                  for t in (p, g, m, v, *outs))
    for i in range(0, pf.numel(), _STEP_ELEMS):
        sl = slice(i, i + _STEP_ELEMS)
        gs = gf[sl].float() * scale
        ms = cfg.b1 * mf[sl].float() + (1 - cfg.b1) * gs
        vs = cfg.b2 * vf[sl].float() + (1 - cfg.b2) * gs * gs
        v_hat = vs / c2
        update = (ms / c1) / (torch.sqrt(v_hat) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            update = update + cfg.weight_decay * pf[sl].float()
        pn[sl] = (pf[sl].float() - lr * update).to(p.dtype)
        mn[sl] = ms
        vn[sl] = vs
    return tuple(outs)


__all__ = ["OptimizerConfig", "init_opt_state", "apply_updates",
           "lr_schedule", "global_norm", "param_leaves", "leaf_grads"]
