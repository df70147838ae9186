"""GQA/MQA attention (+ qk-norm, bias, sliding window, softcap).

Counterpart of the GQA parts of ``repro/models/attention.py``, two paths:

* full sequence (prefill, embedding passes): ``kernels.ops.
  flash_attention``, the hand-written kernel on the card, the plain
  version on the CPU;
* decode: one query position against a preallocated KV cache, a dense f32
  masked softmax (memory-bound, no kernel), as in the reference.

Weights keep the JAX shapes (``wq (d, h, hd)``, ``wo (h, hd, d)``) and
activations the ``(B, S, H, D)`` layout. The reference's sharding
constraints and barriers are the identity off a mesh and are left out.
MLA (DeepSeek-V2) is not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (apply_rope, dense_init, frozen,
                                       rms_norm, softcap)

NEG_INF = -1e30


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
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
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
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


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
    qh = q.reshape(B, kv, h // kv, hd)  # fold the group into q
    logits = torch.einsum("bgrk,bsgk->bgrs", qh.float(),
                          cache["k"].float()) * (hd ** -0.5)
    logits = softcap(logits, cfg.attn_logit_softcap or None)
    kpos = torch.arange(S_max, device=x.device)
    mask = kpos <= index
    if window:
        mask &= kpos > index - window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrs,bsgk->bgrk", probs, cache["v"].float())
    out = out.reshape(B, 1, h, hd).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


__all__ = ["init_attention", "init_kv_cache", "attention_full",
           "attention_decode", "NEG_INF"]
