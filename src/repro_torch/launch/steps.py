"""The three entry points of an LM cell, the port's copy of ``repro/
launch/steps.py``: ``train_step``, ``prefill_step``, ``serve_step``.

``train_step`` is the full production step on one card: gradients are
the loss's ``backward()`` (the parameters must require a gradient:
``params.requires_grad_(True)``); with ``microbatches > 1`` the batch is
cut into equal slices along its first axis, each slice's gradients added
into an f32 accumulator, and the sums and the loss divided by the count;
then the clip and AdamW (``optim.apply_updates``). ``serve_step`` is one
token of decode against a preallocated cache; ``prefill_step`` a forward
pass producing logits.

The dry run's helpers follow the reference's: ``default_microbatches``,
``resolve_strategy``, ``batch_struct`` (``meta`` tensors in place of
``ShapeDtypeStruct``s), ``input_specs`` and ``cell_fn_and_args``, which
build a cell's arguments on ``meta`` with their placements
(``sharding.rules``) beside them. ``lower_cell`` has no counterpart:
eager PyTorch lowers nothing, and the dry run counts a cell's bytes from
the placements and its FLOPs from a run on ``meta``.

With a ``mesh`` (a ``DeviceMesh``) ``make_train_step`` is the reference's
mesh branch: the parameters, optimizer state and batch are DTensors
(``sharding.rules.distribute``), and each microbatch's gradients and the
f32 accumulator are redistributed to their parameters' placements, so a
data-parallel gradient's partial sum is reduced there (a reduce-scatter
where the parameter is sharded), not later. A microbatch is each rank's
own slice of its batch rows (no rows move), so every leaf's rows must
split into ``microbatches`` equal slices on every rank (the global batch
a multiple of the row blocks times the microbatches), else the step
raises before any collective; the loss is a replicated scalar before
``backward``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec, shape_by_name
from repro_torch.models import lm
from repro_torch.optim import OptimizerConfig, apply_updates, init_opt_state
from repro_torch.sharding import (batch_pspecs, cache_pspecs, dp_axes,
                                  param_pspecs)
from repro_torch.sharding.activation import is_dtensor, replicated_like
from repro_torch.sharding.rules import reference_cache_leaves


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
    tensors on its device.

    ``train_step(..., repeat=counter.repeat)`` runs the microbatch loop's
    body once, on the first slice, under ``repeat(microbatches)``: a
    ``FlopCounter`` then counts the whole step from one slice, as the
    reference's counter multiplies its scan over microbatches (the dry
    run's count of a train cell)."""
    if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
        raise ValueError(f"mesh must be a torch.distributed DeviceMesh, "
                         f"got {type(mesh).__name__}")
    if microbatches < 1:
        raise ValueError(f"microbatches {microbatches} < 1")

    def grads_of(params, batch):
        loss = lm.train_step_loss(params, cfg, batch)
        if mesh is not None:
            loss = _replicated(loss)
        loss.backward()
        grads = _grads(params)
        if mesh is not None:
            grads = shard_like_params(params, grads)
        return loss.detach(), grads

    def train_step(params, opt_state, batch, repeat=None):
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
            for k, t in batch.items():
                n = _row_blocks(t)
                if t.shape[0] % (n * microbatches):
                    raise ValueError(
                        f"batch leaf {k!r}: {t.shape[0]} rows in {n} "
                        f"blocks do not split into {microbatches} "
                        f"microbatches of equal rows on every rank")
            b = B // microbatches
            # the f32 accumulator, placed like the parameters
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in params.named_parameters()}
            first = next(iter(grads.values()))
            acc = {"loss": replicated_like(torch.zeros(
                (), dtype=torch.float32, device=first.device), first)}

            def body(i):
                mb = {k: _rows(t, i, microbatches, b)
                      for k, t in batch.items()}
                l, g = grads_of(params, mb)
                acc["loss"] = acc["loss"] + l
                for n, t in g.items():
                    grads[n].add_(t.float())

            if repeat is None:
                for i in range(microbatches):
                    body(i)
            else:
                with repeat(microbatches):
                    body(0)
            loss = acc["loss"] / microbatches
            grads = {n: t / microbatches for n, t in grads.items()}
        if mesh is not None:
            loss = loss.to_local()  # replicated: every rank's whole value
        params, opt_state, stats = apply_updates(params, grads, opt_state,
                                                 opt_cfg)
        return params, opt_state, {"loss": loss, **stats}

    return train_step


def _replicated(t):
    """A DTensor (a partial sum, or sharded) replicated on its mesh."""
    from torch.distributed.tensor import Replicate

    mesh = t.device_mesh
    want = (Replicate(),) * mesh.ndim
    return t if tuple(t.placements) == want else t.redistribute(mesh, want)


def shard_like_params(params, grads: dict) -> dict:
    """Each DTensor gradient redistributed to its parameter's placements
    (the reference's ``shard_like_params``)."""
    out = {}
    for n, p in params.named_parameters():
        g = grads[n]
        if tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        out[n] = g
    return out


def _row_blocks(t) -> int:
    """How many blocks a batch leaf's rows are cut into across the ranks
    (1 for a plain tensor): the product of the mesh dims its placements
    shard dim 0 over."""
    if not is_dtensor(t):
        return 1
    return math.prod(t.device_mesh.size(i)
                     for i, p in enumerate(t.placements) if p.is_shard(0))


def _rows(t, i: int, n: int, b: int):
    """Microbatch ``i`` of ``n`` of a batch leaf: rows ``i * b`` to ``(i
    + 1) * b``; of a DTensor, each rank's ``i``-th slice of its own rows,
    placed as the whole."""
    if not is_dtensor(t):
        return t[i * b:(i + 1) * b]
    from torch.distributed.tensor import DTensor

    loc = t.to_local()
    bl = loc.shape[0] // n
    return DTensor.from_local(loc[i * bl:(i + 1) * bl], t.device_mesh,
                              t.placements, run_check=False)


def default_microbatches(cfg: ArchConfig, shape: ShapeSpec, mesh,
                         target_tokens_per_device: int = 16_384) -> int:
    """Largest power-of-2 split keeping per-device microbatch tokens at the
    target while the per-microbatch batch still shards over dp."""
    axes = dp_axes(mesh)
    if resolve_strategy(cfg, shape.name, mesh) == "fsdp":
        axes = axes + ("model",)
    dp = math.prod(mesh.shape[a] for a in axes)
    B, S = shape.global_batch, shape.seq_len
    if B % dp:
        return 1
    b_dev = B // dp
    k = 1
    while (k < b_dev and (b_dev // k) * S > target_tokens_per_device
           and b_dev % (2 * k) == 0):
        k *= 2
    return k


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        with torch.no_grad():
            if cfg.is_encoder_decoder:
                return lm.forward_encdec(params, cfg, batch)
            return lm.forward(params, cfg, batch)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, tokens, cache, index):
        with torch.no_grad():
            return lm.decode_step(params, cfg, tokens, cache, index)

    return serve_step


# ---------------------------------------------------------------------------
# shape stand-ins
# ---------------------------------------------------------------------------


def batch_struct(cfg: ArchConfig, shape: ShapeSpec, device="meta") -> dict:
    """The input batch of one workload shape as empty tensors on
    ``device`` (``meta``: no memory)."""
    B, S = shape.global_batch, shape.seq_len
    dev = torch.device(device)
    ids = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)  # noqa: E731
    acts = lambda *s: torch.empty(s, dtype=lm.dtype_of(cfg.dtype),  # noqa: E731
                                  device=dev)
    if shape.kind == "decode":
        return {"tokens": ids(B, 1)}
    if cfg.is_encoder_decoder:
        return {"frames": acts(B, cfg.n_frontend_tokens, cfg.d_model),
                "tokens": ids(B, S), "labels": ids(B, S)}
    if cfg.frontend == "vision_stub":
        s_txt = S - cfg.n_frontend_tokens
        return {"tokens": ids(B, s_txt),
                "patch_embeds": acts(B, cfg.n_frontend_tokens, cfg.d_model),
                "labels": ids(B, s_txt)}
    return {"tokens": ids(B, S), "labels": ids(B, S)}


def resolve_strategy(cfg: ArchConfig, shape_name: str, mesh) -> str:
    """Per-cell strategy with a divisibility guard: fsdp needs the global
    batch to split across EVERY mesh axis (e.g. granite's fsdp override
    applies on the 256-device pod but falls back to tp_sp on 512)."""
    strategy = cfg.strategy_for(shape_name)
    if strategy == "fsdp":
        total = math.prod(mesh.shape.values())
        if shape_by_name(shape_name).global_batch % total:
            return "tp_sp"
    return strategy


def input_specs(cfg: ArchConfig, shape_name: str, mesh,
                opt_cfg: OptimizerConfig | None = None, device="meta"):
    """One (arch x shape) cell's arguments on ``device`` (``meta``: no
    memory) and their placements on ``mesh``.

    Returns ``(kind, args, specs)``: train -> ``(params, opt_state,
    batch)``; prefill -> ``(params, batch)``; decode -> ``(params, tokens,
    cache, index)``, ``index`` the last position (a Python int; an int32
    scalar in the reference). ``specs`` holds one ``{path: spec}`` an
    argument, by the reference's leaf paths (a cache's in its stacked
    form, ``reference_cache_leaves``); the parameters of a train cell
    require a gradient."""
    shape = shape_by_name(shape_name)
    opt_cfg = opt_cfg or OptimizerConfig()
    params = lm.init_lm(0, cfg, device=device)
    pspecs = param_pspecs(params, mesh)

    strategy = resolve_strategy(cfg, shape.name, mesh)
    batch = batch_struct(cfg, shape, device)
    bspecs = batch_pspecs(batch, mesh, strategy)

    if shape.kind == "train":
        opt_state = init_opt_state(params, opt_cfg)
        ospecs = param_pspecs(opt_state, mesh)
        return ("train", (params.requires_grad_(True), opt_state, batch),
                (pspecs, ospecs, bspecs))

    if shape.kind == "prefill":
        return "prefill", (params, batch), (pspecs, bspecs)

    # decode: preallocated cache of seq_len, one new token
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len, device)
    cspecs = cache_pspecs(reference_cache_leaves(cache), mesh, strategy)
    return ("decode", (params, batch["tokens"], cache, shape.seq_len - 1),
            (pspecs, {"tokens": bspecs["tokens"]}, cspecs, {"index": ()}))


def cell_fn_and_args(cfg: ArchConfig, shape_name: str, mesh,
                     opt_cfg: OptimizerConfig | None = None,
                     microbatches: int | None = None, device="meta"):
    """``(kind, fn, args, specs)`` for one (arch x shape) cell
    (``input_specs``); a train cell's ``fn`` splits its batch into
    ``default_microbatches`` unless ``microbatches`` is given."""
    kind, args, specs = input_specs(cfg, shape_name, mesh, opt_cfg, device)
    opt_cfg = opt_cfg or OptimizerConfig()
    if kind == "train":
        if microbatches is None:
            microbatches = default_microbatches(
                cfg, shape_by_name(shape_name), mesh,
                target_tokens_per_device=cfg.microbatch_target_tokens)
        return (kind, make_train_step(cfg, opt_cfg, microbatches), args,
                specs)
    if kind == "prefill":
        return kind, make_prefill_step(cfg), args, specs
    return kind, make_serve_step(cfg), args, specs


__all__ = ["make_train_step", "shard_like_params", "make_prefill_step",
           "make_serve_step",
           "default_microbatches", "batch_struct", "resolve_strategy",
           "input_specs", "cell_fn_and_args"]
