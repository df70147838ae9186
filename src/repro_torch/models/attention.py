"""Attention layers: GQA/MQA (+ qk-norm, bias, sliding window, softcap),
and MLA (DeepSeek-V2).

Counterpart of ``repro/models/attention.py``, two paths:

* full sequence (prefill, embedding passes): ``kernels.ops.
  flash_attention``, the hand-written kernel on the card, the plain
  version on the CPU;
* decode: one query position against a preallocated KV cache, a dense f32
  masked softmax (memory-bound, no kernel), as in the reference.

MLA keeps low-rank K/V: the full-sequence pass decompresses them and runs
MHA through the same kernel at head dim ``qk_nope + qk_rope`` (192 for
deepseek-v2) with an explicit scale, ``v`` padded to that width and
sliced back; decode runs the absorbed form, attending in the latent space,
so the cache holds only the ``kv_lora``-wide latents and the rope key.

Weights keep the JAX shapes (``wq (d, h, hd)``, ``wo (h, hd, d)``) and
activations the ``(B, S, H, D)`` layout. The reference's sharding
constraints stand where it has them (``sharding.activation.constrain``:
the identity on a plain tensor, a redistribution of a sharded program's
DTensor): the Megatron-SP all-gather of the sequence before the
projections, heads over ``"model"`` after them and on the attention's
output. Its ``optimization_barrier`` stops XLA fusing across the gather;
eager PyTorch fuses nothing, so the port has none.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (apply_rope, dense_init, frozen,
                                       rms_norm, softcap)
from repro_torch.sharding.activation import (BATCH_AXES, Out, constrain,
                                            gather_dims, gathered,
                                            is_dtensor, mesh_size, on_blocks,
                                            reduce_partial, replicated_like,
                                            reshard)

NEG_INF = -1e30

# tensor-parallel layouts: heads shard over "model" (nothing where the head
# count does not divide: MQA's K/V stay replicated)
_HEADS_TP = (BATCH_AXES, None, "model", None)


def init_attention(generator: torch.Generator, cfg: ArchConfig,
                   dtype) -> nn.ParameterDict:
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    dev = generator.device
    p = {
        "wq": dense_init((d, h, hd), dtype, generator),
        "wk": dense_init((d, kv, hd), dtype, generator),
        "wv": dense_init((d, kv, hd), dtype, generator),
        "wo": dense_init((h, hd, d), dtype, generator),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return frozen(p)


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                  device) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, max_len, kv, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype,
                         device=device),
    }


def _project_qkv(p, x, cfg: ArchConfig, positions, theta):
    # the Megatron-SP all-gather: the sequence whole before the projections
    x = constrain(x, (BATCH_AXES, None, None))
    # a sharded program gathers each weight over the data axes (FSDP) and,
    # where the heads cannot shard, over the head_dim it keeps sharded at
    # rest (``gathered``)
    q = constrain(torch.einsum("bsd,dhk->bshk", x, gathered(p["wq"], (2,))),
                  _HEADS_TP)
    k = constrain(torch.einsum("bsd,dhk->bshk", x, gathered(p["wk"], (2,))),
                  _HEADS_TP)
    v = constrain(torch.einsum("bsd,dhk->bshk", x, gathered(p["wv"], (2,))),
                  _HEADS_TP)
    if cfg.qkv_bias:
        q = q + gathered(p["bq"], (1,))
        k = k + gathered(p["bk"], (1,))
        v = v + gathered(p["bv"], (1,))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    return q, k, v


def attention_full(p, x, cfg: ArchConfig, *, positions, window: int = 0,
                   causal: bool = True, theta: float = 10_000.0):
    """Full-sequence attention (prefill). ``x (B, S, D)``."""
    q, k, v = _project_qkv(p, x, cfg, positions, theta)
    out = kops.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window or None, softcap=cfg.attn_logit_softcap or None)
    out = constrain(out, _HEADS_TP)
    return torch.einsum("bshk,hkd->bsd", out, gathered(p["wo"], (1,)))


def _grouped(q, kv: int):
    """``q (B, 1, H, hd)`` ready to fold its heads into ``kv`` groups: a
    sharded program's heads are gathered where ``kv`` does not divide over
    the mesh dims that shard them (the fold would split a sharded
    dimension unevenly)."""
    if not is_dtensor(q):
        return q
    n = math.prod(q.device_mesh.size(i) for i, pl in enumerate(q.placements)
                  if pl.is_shard(2))
    if kv % n == 0:
        return q
    return constrain(q, (BATCH_AXES, None, None, None))


def attention_decode(p, x, cfg: ArchConfig, cache: dict, index: int,
                     *, window: int = 0, theta: float = 10_000.0):
    """One-token decode. ``x (B, 1, D)``; cache k/v ``(B, S_max, Kv,
    hd)``. ``index`` is the number of tokens already in the cache (the new
    token's position). The new key and value are written into the cache
    in place (the reference's ``dynamic_update_slice`` under donation);
    returns ``(out (B, 1, D), cache)``."""
    B = x.shape[0]
    S_max = cache["k"].shape[1]
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos, theta)
    cache["k"][:, index] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, index] = v_new[:, 0].to(cache["v"].dtype)

    h, kv = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    qh = _grouped(q, kv).reshape(B, kv, h // kv, hd)  # fold the group in
    logits = torch.einsum("bgrk,bsgk->bgrs", qh.float(),
                          cache["k"].float()) * (hd ** -0.5)
    # a sharded program's scores are a partial sum over "model" where the
    # cache's head_dim is split (the kv heads do not divide); the
    # reference leaves them to XLA. Pinned: reduce-scattered onto the
    # group's heads where they divide (the softmax then runs on each
    # rank's heads; the census counts 1/m of the scores, m ranks on
    # "model", an all-reduce the whole), else onto the keys and gathered
    # for the softmax. That route counts (m + 1)/m of the scores in the
    # census's result bytes, an all-reduce 1; on the link the two move
    # the same bytes (a ring all-reduce is a reduce-scatter and an
    # all-gather), and the decode step keeps no all-reduce of the scores
    # (PERF.md §6 counts the cells where the census sees the 1/m more)
    heads_split = (h // kv) % mesh_size("model") == 0
    logits = reduce_partial(logits, 2 if heads_split else 3)
    logits = softcap(logits, cfg.attn_logit_softcap or None)
    kpos = torch.arange(S_max, device=x.device)
    mask = kpos <= index
    if window:
        mask &= kpos > index - window
    logits = torch.where(replicated_like(mask, logits), logits, NEG_INF)
    probs = torch.softmax(gather_dims(logits, (3,)), dim=-1)
    v = cache["v"]
    if heads_split and is_dtensor(v) and any(
            pl.is_shard(3) for pl in v.placements):
        if any(pl.is_shard(1) for pl in v.placements):
            # keys split over the data axes: head_dim gathered instead
            v = gather_dims(v, (3,))
        else:
            # both onto the keys (two all-to-alls of a head's block, not
            # a gather of the scores or the cache): the product is then
            # a partial sum, reduce-scattered onto the heads below
            probs, v = reshard(probs, 2, 3), reshard(v, 3, 1)
    out = torch.einsum("bgrs,bsgk->bgrk", probs, v.float())
    # heads over "model" where they divide, as the full pass pins them (a
    # sharded program's head_dim, split with the cache's, comes back whole)
    out = constrain(out.reshape(B, 1, h, hd).to(x.dtype), _HEADS_TP)
    return torch.einsum("bshk,hkd->bsd", out,
                        gathered(p["wo"], (1,))), cache


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(generator: torch.Generator, cfg: ArchConfig,
             dtype) -> nn.ParameterDict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = generator.device
    return frozen({
        "wq_a": dense_init((d, m.q_lora_rank), dtype, generator),
        "q_norm": torch.ones((m.q_lora_rank,), dtype=dtype, device=dev),
        "wq_b": dense_init((m.q_lora_rank, h, qk), dtype, generator),
        "wkv_a": dense_init((d, m.kv_lora_rank + m.qk_rope_head_dim), dtype,
                            generator),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dtype, device=dev),
        "wk_b": dense_init((m.kv_lora_rank, h, m.qk_nope_head_dim), dtype,
                           generator),
        "wv_b": dense_init((m.kv_lora_rank, h, m.v_head_dim), dtype,
                           generator),
        "wo": dense_init((h, m.v_head_dim, d), dtype, generator),
    })


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
    }


def _mla_query(p, x, cfg: ArchConfig, positions, theta):
    """``(q_nope, q_rope)`` of ``x (B, S, D)``, the rope part rotated."""
    m = cfg.mla
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, gathered(p["wq_a"])),
                  p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, gathered(p["wq_b"], (2,)))
    return (q[..., :m.qk_nope_head_dim],
            apply_rope(q[..., m.qk_nope_head_dim:], positions, theta))


def _mla_latent(p, x, cfg: ArchConfig, positions, theta):
    """``(c_kv (B, S, kv_lora), k_rope (B, S, 1, rope))``: the normed
    latents and the rotated rope key shared across the heads."""
    m = cfg.mla
    ckv_full = torch.einsum("bsd,dr->bsr", x, gathered(p["wkv_a"]))
    c_kv = rms_norm(ckv_full[..., :m.kv_lora_rank], p["kv_norm"],
                    cfg.norm_eps)
    k_rope = apply_rope(ckv_full[:, :, None, m.kv_lora_rank:], positions,
                        theta)
    return c_kv, k_rope


def mla_full(p, x, cfg: ArchConfig, *, positions, theta: float = 10_000.0):
    """Unabsorbed MLA (prefill): decompress K/V, run MHA through
    ``flash_attention`` at head dim ``qk_nope + qk_rope`` with the scale
    of that width; ``v`` is zero-padded to it and the output sliced
    back. A sharded program's q, k and v reach the kernel over batch and
    heads (the rope key, shared by the heads, is sliced to each rank's
    heads before it joins them)."""
    m = cfg.mla
    B, S, _ = x.shape
    h = cfg.n_heads
    x = constrain(x, (BATCH_AXES, None, None))  # the SP all-gather
    q_nope, q_rope = _mla_query(p, x, cfg, positions, theta)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions, theta)
    k_nope = constrain(torch.einsum("bsr,rhk->bshk", c_kv,
                                    gathered(p["wk_b"], (2,))), _HEADS_TP)
    v = constrain(torch.einsum("bsr,rhk->bshk", c_kv,
                               gathered(p["wv_b"], (2,))), _HEADS_TP)
    qk = constrain(torch.cat([q_nope, q_rope], dim=-1), _HEADS_TP)
    del q_nope, q_rope
    kk = torch.cat([k_nope, constrain(
        k_rope.expand(B, S, h, m.qk_rope_head_dim), _HEADS_TP)], dim=-1)
    del k_nope
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    pad = qk.shape[-1] - v.shape[-1]  # on each rank's block
    vp = on_blocks(lambda t: torch.nn.functional.pad(t, (0, pad)), (v,),
                   (None,), (Out(0, (0, 1, 2, 3)),))
    del v
    out = kops.flash_attention(qk, kk, vp, causal=True, scale=scale)
    del qk, kk, vp
    out = constrain(out, _HEADS_TP)
    return torch.einsum("bshk,hkd->bsd", out[..., :m.v_head_dim],
                        gathered(p["wo"], (1,)))


def mla_decode(p, x, cfg: ArchConfig, cache: dict, index: int,
               *, theta: float = 10_000.0):
    """Absorbed MLA decode, attending in the ``kv_lora`` latent space:
    ``wk_b`` folds into the query, ``wv_b`` applies after the weighted
    latent sum. The new latent and rope key are written into the cache
    in place; returns ``(out (B, 1, D), cache)``."""
    m = cfg.mla
    B = x.shape[0]
    S_max = cache["c_kv"].shape[1]
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_query(p, x, cfg, pos, theta)
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])  # (B,1,H,rank)
    c_new, kr_new = _mla_latent(p, x, cfg, pos, theta)
    cache["c_kv"][:, index] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, index] = kr_new[:, 0, 0].to(cache["k_rope"].dtype)

    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    c_f = cache["c_kv"].float()
    logits = (torch.einsum("bshr,btr->bhst", q_c.float(), c_f)
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             cache["k_rope"].float())) * scale
    mask = torch.arange(S_max, device=x.device) <= index
    logits = torch.where(replicated_like(mask, logits), logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out_c = torch.einsum("bhst,btr->bshr", probs, c_f)  # (B,1,H,rank)
    out = torch.einsum("bshr,rhk->bshk", out_c.to(x.dtype), p["wv_b"])
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


__all__ = ["init_attention", "init_kv_cache", "attention_full",
           "attention_decode", "init_mla", "init_mla_cache", "mla_full",
           "mla_decode", "NEG_INF"]
