"""Block assembly and the layer stack.

Counterpart of ``repro/models/blocks.py``. A layer is of one *kind*:

    attn            full-attention block (+ MoE if configured)
    attn_local      sliding-window attention block
    dense_ffn_attn  attention + dense FFN even in an MoE model
                    (deepseek-v2's first layer)
    rglru           Griffin recurrent block + MLP
    mlstm / slstm   xLSTM blocks (self-contained, no separate FFN)

Attention is GQA or MLA, the FFN a dense MLP or an MoE. Consecutive
layers of one kind form a *run* (``pattern_runs``), as in the reference,
so that a run's parameters map onto the reference's stacked run one layer
at a time. A run is an ``nn.ModuleList`` of blocks looped in Python (the
reference's ``lax.scan``). Caches are a list of runs, each a list of
per-layer dicts: ``{"k", "v"}`` (``{"c_kv", "k_rope"}`` with MLA) or a
recurrent state, updated in place.

For training, as in the reference: the full-sequence blocks return the
MoE's load-balancing loss beside ``x`` (zero for a block without an MoE),
summed in f32 through the stack; each block's input passes
``boundary.grad_compressed_boundary`` (active only inside the trainer's
``compressed_boundaries()``); and with ``cfg.remat`` ``"full"`` or
``"dots"`` a block whose parameters require a gradient runs under
``torch.utils.checkpoint`` while grad is enabled, so its activations are
recomputed in the backward pass (serving never enters it). ``"dots"``
saves the products without a batch dimension and recomputes the rest
(``DOTS_POLICY``).

The reference's layout constraints stand where it has them
(``sharding.activation.constrain``, the identity on a plain tensor): a
block's input and output in the Megatron-SP layout (``SP_SPEC``), and,
for a sharded program's DTensors, the attention and MLP outputs too,
whose partial sums are reduce-scattered before the residual (so their
gradients come back gathered, not split along the sequence).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_m
from repro_torch.models import mlp as mlp_m
from repro_torch.models import recurrent as rec_m
from repro_torch.models.boundary import grad_compressed_boundary
from repro_torch.models.common import frozen, layer_norm, rms_norm
from repro_torch.sharding.activation import (BATCH_AXES, constrain,
                                            replicated_like)

ATTN_KINDS = ("attn", "attn_local", "dense_ffn_attn")
# Megatron-style sequence parallelism: the residual stream between blocks
# lives sharded (batch over the data axes, sequence over "model"); a
# sharded program gathers it before attention and the MLP and
# reduce-scatters it after
SP_SPEC = (BATCH_AXES, "model", None)
# the recurrent kinds: the name of the block's parameters
_RECURRENT = {"rglru": "rec", "mlstm": "block", "slstm": "block"}


def _norm_params(cfg: ArchConfig, dtype, device) -> dict:
    if cfg.norm == "layernorm":
        return {"w": torch.ones((cfg.d_model,), dtype=dtype, device=device),
                "b": torch.zeros((cfg.d_model,), dtype=dtype,
                                 device=device)}
    fill = torch.zeros if cfg.rms_offset else torch.ones
    return {"w": fill((cfg.d_model,), dtype=dtype, device=device)}


def apply_norm(p, x, cfg: ArchConfig):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps, offset=cfg.rms_offset)


def init_block(generator: torch.Generator, cfg: ArchConfig, kind: str,
               dtype) -> nn.ModuleDict:
    dev = generator.device
    p = {"ln1": _norm_params(cfg, dtype, dev)}
    if kind in _RECURRENT:
        init = getattr(rec_m, f"init_{kind}_block")
        p[_RECURRENT[kind]] = init(generator, cfg, dtype)
        if kind == "rglru":
            p["ln2"] = _norm_params(cfg, dtype, dev)
            p["mlp"] = mlp_m.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                      dtype)
        return frozen(p)
    if kind not in ATTN_KINDS:
        raise ValueError(kind)
    p["attn"] = (attn_m.init_mla if cfg.mla is not None else
                 attn_m.init_attention)(generator, cfg, dtype)
    p["ln2"] = _norm_params(cfg, dtype, dev)
    if cfg.moe.n_experts and kind != "dense_ffn_attn":
        p["moe"] = mlp_m.init_moe(generator, cfg, dtype)
    else:
        p["mlp"] = mlp_m.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype)
    if cfg.post_norms:
        p["post_attn"] = _norm_params(cfg, dtype, dev)
        p["post_mlp"] = _norm_params(cfg, dtype, dev)
    return frozen(p)


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                     dtype, device) -> dict:
    if kind == "rglru":
        return rec_m.init_rglru_state(cfg, batch, dtype, device)
    if kind == "mlstm":
        return rec_m.init_mlstm_state(cfg, batch, dtype, device)
    if kind == "slstm":
        return rec_m.init_slstm_state(cfg, batch, device)
    if kind not in ATTN_KINDS:
        raise ValueError(kind)
    if cfg.mla is not None:
        return attn_m.init_mla_cache(cfg, batch, max_len, dtype, device)
    return attn_m.init_kv_cache(cfg, batch, max_len, dtype, device)


def _attn_kwargs(cfg: ArchConfig, kind: str):
    window = cfg.window if kind == "attn_local" else 0
    theta = cfg.rope_theta_local if kind == "attn_local" else cfg.rope_theta
    return window, theta


def _zero_aux(x) -> torch.Tensor:
    return replicated_like(
        torch.zeros((), dtype=torch.float32, device=x.device), x)


def _ffn(p, x, cfg: ArchConfig, decode: bool = False):
    """The block's second half: norm, MLP or MoE, optional post-norm,
    residual. Returns ``(x, aux)``: the MoE's load-balancing loss, None
    for a dense MLP."""
    h = apply_norm(p["ln2"], x, cfg)
    if "moe" in p:
        f, aux = mlp_m.moe(p["moe"], h, cfg, decode=decode)
    else:
        f, aux = mlp_m.mlp(p["mlp"], h, cfg.act), None
    f = constrain(f, SP_SPEC)  # the partial sum reduce-scattered
    if cfg.post_norms:
        f = apply_norm(p["post_mlp"], f, cfg)
    return x + f, aux


def _recurrent(p, x, cfg: ArchConfig, kind: str, form: str, *args):
    """A recurrent block: the norm, ``{kind}_block_{form}`` of
    ``models/recurrent.py`` (form ``full`` or ``step``), the residual,
    and for ``rglru`` the MLP half. Returns ``(x, state)``."""
    fn = getattr(rec_m, f"{kind}_block_{form}")
    r, state = fn(p[_RECURRENT[kind]], apply_norm(p["ln1"], x, cfg), cfg,
                  *args)
    # a sharded program's partial sums reduce-scattered to the SP layout
    x = x + constrain(r, SP_SPEC)
    if kind == "rglru":
        h = apply_norm(p["ln2"], x, cfg)
        x = x + constrain(mlp_m.mlp(p["mlp"], h, cfg.act), SP_SPEC)
    return x, state


def apply_block_full(p, x, cfg: ArchConfig, kind: str, positions,
                     causal: bool = True):
    """Full-sequence block application (train / prefill). Returns ``(x,
    aux)``, ``aux`` the MoE's load-balancing loss (f32, zero without
    one)."""
    x = constrain(x, SP_SPEC)
    x = grad_compressed_boundary(x, SP_SPEC)
    if kind in _RECURRENT:
        x = _recurrent(p, x, cfg, kind, "full")[0]
        return constrain(x, SP_SPEC), _zero_aux(x)
    window, theta = _attn_kwargs(cfg, kind)
    h = apply_norm(p["ln1"], x, cfg)
    if cfg.mla is not None:
        a = attn_m.mla_full(p["attn"], h, cfg, positions=positions,
                            theta=theta)
    else:
        a = attn_m.attention_full(p["attn"], h, cfg, positions=positions,
                                  window=window, causal=causal, theta=theta)
    # a sharded program's output projection is a partial sum over the
    # heads: reduce-scattered to the SP layout here, so its gradient comes
    # back whole (an all-gather) rather than split along the sequence
    a = constrain(a, SP_SPEC)
    if cfg.post_norms:
        a = apply_norm(p["post_attn"], a, cfg)
    x, aux = _ffn(p, x + a, cfg)
    x = constrain(x, SP_SPEC)  # the reduce-scatter back to the SP layout
    return x, _zero_aux(x) if aux is None else aux


def apply_block_decode(p, x, cfg: ArchConfig, kind: str, cache, index: int):
    """One-token decode. Returns ``(x, cache)``; the cache is updated in
    place."""
    if kind in _RECURRENT:
        return _recurrent(p, x, cfg, kind, "step", cache)
    window, theta = _attn_kwargs(cfg, kind)
    h = apply_norm(p["ln1"], x, cfg)
    if cfg.mla is not None:
        a, cache = attn_m.mla_decode(p["attn"], h, cfg, cache, index,
                                     theta=theta)
    else:
        a, cache = attn_m.attention_decode(p["attn"], h, cfg, cache, index,
                                           window=window, theta=theta)
    # a sharded program's output projection is a partial sum over the
    # heads; the reference leaves it to XLA. Pinned to the SP layout the
    # MLP's output takes (``_ffn``), all-reduced in the activation dtype
    # before the residual, not later in the norm's f32
    a = constrain(a, SP_SPEC)
    if cfg.post_norms:
        a = apply_norm(p["post_attn"], a, cfg)
    return _ffn(p, x + a, cfg, decode=True)[0], cache


# ---------------------------------------------------------------------------
# runs: consecutive identical kinds
# ---------------------------------------------------------------------------


def pattern_runs(pattern) -> list[tuple[str, int]]:
    runs = []
    for kind in pattern:
        if runs and runs[-1][0] == kind:
            runs[-1] = (kind, runs[-1][1] + 1)
        else:
            runs.append((kind, 1))
    return runs


def init_layer_stack(generator: torch.Generator, cfg: ArchConfig,
                     dtype) -> nn.ModuleList:
    """One ``nn.ModuleList`` of blocks per run."""
    return nn.ModuleList(
        nn.ModuleList(init_block(generator, cfg, kind, dtype)
                      for _ in range(length))
        for kind, length in pattern_runs(cfg.pattern))


_aten = torch.ops.aten


def dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: the port's reading of the reference's
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``. A
    projection's ``einsum`` (``"bsd,dhk->bshk"``) emits ``aten.bmm`` with
    a batch of one, and a ``matmul`` of ``(B, S, d)`` by ``(d, f)``
    folds into ``aten.mm``: products without a batch dimension, saved.
    The attention's scores (``"bgrk,bsgk->bgrs"``) and the MoE's
    ``bmm`` over experts carry one and are recomputed, as is everything
    else, the ``flash_attention`` Function included."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.PREFER_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, cfg: ArchConfig, p: nn.Module, x: torch.Tensor):
    """``fn`` under ``torch.utils.checkpoint`` when ``cfg.remat`` is
    ``"full"`` or ``"dots"`` (``dots_policy`` selects what is saved),
    grad is enabled and ``p`` (the layer's parameters) or ``x`` requires
    a gradient: the reference's ``_remat`` around each layer. Otherwise
    ``fn`` itself."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if not (x.requires_grad or next(p.parameters()).requires_grad):
        return fn
    if cfg.remat == "dots":
        return lambda *a: checkpoint(
            fn, *a, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(
                dots_policy))
    if cfg.remat != "full":
        raise ValueError(f"remat={cfg.remat!r}: one of 'full', 'dots', "
                         "'none'")
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def apply_stack_full(stacks, x, cfg: ArchConfig, positions,
                     causal: bool = True):
    """All runs, full sequence. Returns ``(x, aux)``: ``aux`` the blocks'
    MoE losses summed in f32 in layer order."""
    aux = _zero_aux(x)
    for (kind, _), run in zip(pattern_runs(cfg.pattern), stacks):
        for p in run:
            x, a = remat(apply_block_full, cfg, p, x)(
                p, x, cfg, kind, positions, causal)
            aux = aux + a
    return x, aux


def apply_stack_decode(stacks, x, cfg: ArchConfig, caches, index: int):
    """One-token decode through all runs; ``caches`` is aligned with the
    runs and updated in place."""
    for (kind, _), run, run_cache in zip(pattern_runs(cfg.pattern), stacks,
                                         caches):
        for p, cache in zip(run, run_cache):
            x, _ = apply_block_decode(p, x, cfg, kind, cache, index)
    return x, caches


def init_stack_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                     device) -> list:
    return [[init_block_cache(cfg, kind, batch, max_len, dtype, device)
             for _ in range(length)]
            for kind, length in pattern_runs(cfg.pattern)]


__all__ = ["init_block", "apply_block_full", "apply_block_decode",
           "pattern_runs", "init_layer_stack", "apply_stack_full",
           "apply_stack_decode", "init_stack_cache", "init_block_cache",
           "apply_norm", "remat", "dots_policy", "ATTN_KINDS"]
