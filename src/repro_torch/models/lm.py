"""Language models: the decoder-only LM and the encoder-decoder.

Counterpart of ``repro/models/lm.py`` for inference (``init_lm``,
``embed_tokens``, ``lm_logits``, ``hidden_forward``, ``forward``,
``init_cache``, ``decode_step``, and the encoder-decoder's ``encode``,
``forward_encdec``, ``prefill_cross_cache``, ``decode_encdec_body``):

* decoder-only: token embedding (the vision stub prepends a batch's
  precomputed ``patch_embeds``), the layer stack, final norm, (tied) head;
* encoder-decoder (whisper): a batch's precomputed ``frames`` plus
  sinusoidal positions through a non-causal encoder; the decoder adds
  learned positions, and each layer runs its self-attention block, then
  cross-attention over the encoder's keys and values (``flash_attention``,
  non-causal), which decode reads from a cache filled once.

The parameters are an ``LmParams`` module indexed like the reference's
dict (``params["embed"]``, ``params["layers"]``, ``params["final_norm"]``,
``params["lm_head"]`` when untied; ``params["encoder"]``,
``params["cross"]`` (one entry a decoder layer) and
``params["pos_embed_dec"]`` for an encoder-decoder).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import resolve
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_m
from repro_torch.models import blocks as blk
from repro_torch.models.common import (dense_init, embed_init, frozen,
                                       sinusoidal_positions)

POS_DEC = 32_768  # learned decoder positions: the largest assigned shape


def dtype_of(name: str) -> torch.dtype:
    """``torch.bfloat16`` for ``"bfloat16"``, and so on."""
    return getattr(torch, name)


class LmParams(nn.Module):
    """The model's parameters, frozen: ``embed (V_pad, d)``, ``layers``
    (one ``nn.ModuleList`` of blocks per run), ``final_norm``; for an
    untied head ``lm_head (d, V_pad)``; for an encoder-decoder
    ``encoder`` (runs, as ``layers``), ``cross`` (one ``{"ln", "attn"}``
    a decoder layer) and ``pos_embed_dec (POS_DEC, d)``."""

    def __init__(self, embed: torch.Tensor, layers: nn.ModuleList,
                 final_norm: dict, lm_head: torch.Tensor | None = None,
                 encoder: nn.ModuleList | None = None,
                 cross: nn.ModuleList | None = None,
                 pos_embed_dec: torch.Tensor | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = layers
        self.final_norm = frozen(final_norm)
        self.lm_head = _frozen_tensor(lm_head)
        self.encoder = encoder
        self.cross = cross
        self.pos_embed_dec = _frozen_tensor(pos_embed_dec)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return getattr(self, name, None) is not None


def _frozen_tensor(t):
    return None if t is None else nn.Parameter(t, requires_grad=False)


def init_lm(generator: torch.Generator | int, cfg: ArchConfig,
            device=None) -> LmParams:
    """Random weights, drawn from ``generator`` (or a new generator seeded
    with an int, on ``device``: cuda unless given). The embedding is scaled
    by ``d ** -0.5`` (unit-variance tied logits at init), over the padded
    vocabulary. An encoder-decoder also gets its encoder, its per-layer
    cross-attention and its learned decoder positions."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=resolve(device)).manual_seed(
            int(generator))
    dtype = dtype_of(cfg.param_dtype)
    embed = embed_init((cfg.padded_vocab_size, cfg.d_model), dtype,
                       generator) * (cfg.d_model ** -0.5)
    layers = blk.init_layer_stack(generator, cfg, dtype)
    head = (None if cfg.tie_embeddings else
            dense_init((cfg.d_model, cfg.padded_vocab_size), dtype,
                       generator))
    final_norm = blk._norm_params(cfg, dtype, generator.device)
    if not cfg.is_encoder_decoder:
        return LmParams(embed, layers, final_norm, head)
    return LmParams(embed, layers, final_norm, head,
                    encoder=init_encoder(generator, cfg, dtype),
                    cross=init_cross_stack(generator, cfg, dtype),
                    pos_embed_dec=embed_init((POS_DEC, cfg.d_model), dtype,
                                             generator) * 0.02)


def embed_tokens(params, cfg: ArchConfig, tokens):
    x = F.embedding(tokens, params["embed"]).to(dtype_of(cfg.dtype))
    if cfg.embed_scale:  # sqrt(d) rounded to the activation dtype first
        x = x * x.new_full((), cfg.d_model ** 0.5)
    return x


def lm_logits(params, cfg: ArchConfig, x):
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = torch.einsum("bsd,dv->bsv", x, head.to(x.dtype))
    if cfg.padded_vocab_size != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30  # pad ids are never predicted
    return logits


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def hidden_forward(params, cfg: ArchConfig, batch):
    """Trunk only: embed -> layer stack -> final norm. ``batch["tokens"]
    (B, S_txt)``, and for the vision stub optionally ``batch
    ["patch_embeds"] (B, Np, D)``, prepended; returns ``h (B, S, D)``."""
    x = embed_tokens(params, cfg, batch["tokens"])
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    x = blk.apply_stack_full(params["layers"], x, cfg,
                             _positions(B, S, x.device))
    return blk.apply_norm(params["final_norm"], x, cfg)


def forward(params, cfg: ArchConfig, batch):
    """Logits ``(B, S, V_pad)`` of ``batch`` (see ``hidden_forward``)."""
    return lm_logits(params, cfg, hidden_forward(params, cfg, batch))


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    """``{"self": per-run caches}``; an encoder-decoder adds ``"cross":
    {"k", "v"}``, zeros of ``(L, B, n_enc, Kv, hd)`` until
    ``prefill_cross_cache`` fills them."""
    dtype = dtype_of(cfg.dtype)
    cache = {"self": blk.init_stack_cache(cfg, batch, max_len, dtype,
                                          device)}
    if cfg.is_encoder_decoder:
        shape = (cfg.n_layers, batch, cfg.n_frontend_tokens or 1500,
                 cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["cross"] = {n: torch.zeros(shape, dtype=dtype, device=device)
                          for n in ("k", "v")}
    return cache


def decode_step(params, cfg: ArchConfig, tokens, cache: dict, index: int):
    """One new token per sequence against a filled cache. ``tokens (B,
    1)``; returns ``(logits (B, 1, V_pad), cache)``, the cache updated in
    place at position ``index`` (an encoder-decoder reads its filled
    cross cache)."""
    x = embed_tokens(params, cfg, tokens)
    if cfg.is_encoder_decoder:
        x = x + params["pos_embed_dec"][index].to(x.dtype)
        x = decode_encdec_body(params, cfg, x, cache, index)
    else:
        x, _ = blk.apply_stack_decode(params["layers"], x, cfg,
                                      cache["self"], index)
    x = blk.apply_norm(params["final_norm"], x, cfg)
    return lm_logits(params, cfg, x), cache


# ---------------------------------------------------------------------------
# encoder-decoder (whisper-style; the audio front end is a stub: the batch
# carries precomputed frame embeddings)
# ---------------------------------------------------------------------------


def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    return cfg.replace(layer_pattern=("attn",) * cfg.n_encoder_layers,
                       n_layers=cfg.n_encoder_layers)


def init_encoder(generator: torch.Generator, cfg: ArchConfig,
                 dtype) -> nn.ModuleList:
    return blk.init_layer_stack(generator, _encoder_cfg(cfg), dtype)


def init_cross_stack(generator: torch.Generator, cfg: ArchConfig,
                     dtype) -> nn.ModuleList:
    """Per-decoder-layer cross-attention parameters: ``{"ln", "attn"}``."""
    return nn.ModuleList(
        frozen({"ln": blk._norm_params(cfg, dtype, generator.device),
                "attn": attn_m.init_attention(generator, cfg, dtype)})
        for _ in range(cfg.n_layers))


def encode(params, cfg: ArchConfig, frames):
    """``frames (B, T, D)`` stub embeddings -> the encoder's output ``(B,
    T, D)``: sinusoidal positions added (f32 table cast to the activation
    dtype), then the non-causal encoder stack."""
    x = frames.to(dtype_of(cfg.dtype))
    B, T, _ = x.shape
    x = x + sinusoidal_positions(T, cfg.d_model, x.device).to(x.dtype)
    return blk.apply_stack_full(params["encoder"], x, _encoder_cfg(cfg),
                                _positions(B, T, x.device), causal=False)


def _cross_attention(p, x, k, v, cfg: ArchConfig):
    """``x (B, Sq, D)`` queries over the encoder's ``k, v (B, Skv, Kv,
    hd)``, non-causal, with the residual."""
    h = blk.apply_norm(p["ln"], x, cfg)
    q = torch.einsum("bsd,dhk->bshk", h, p["attn"]["wq"])
    if cfg.qkv_bias:
        q = q + p["attn"]["bq"]
    out = kops.flash_attention(q.contiguous(), k, v, causal=False)
    return x + torch.einsum("bshk,hkd->bsd", out, p["attn"]["wo"])


def _cross_kv(p, enc_out, cfg: ArchConfig):
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["attn"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["attn"]["wv"])
    if cfg.qkv_bias:
        k = k + p["attn"]["bk"]
        v = v + p["attn"]["bv"]
    return k.contiguous(), v.contiguous()


def forward_encdec(params, cfg: ArchConfig, batch):
    """The teacher-forced encoder-decoder pass: logits ``(B, S, V_pad)`` of
    ``batch["tokens"] (B, S)`` given ``batch["frames"] (B, T, D)``."""
    enc_out = encode(params, cfg, batch["frames"])
    x = embed_tokens(params, cfg, batch["tokens"])
    B, S, _ = x.shape
    x = x + params["pos_embed_dec"][:S].to(x.dtype)
    positions = _positions(B, S, x.device)
    if len(params["layers"]) != 1:
        raise ValueError("the encoder-decoder's decoder must be one run")
    for self_p, cross_p in zip(params["layers"][0], params["cross"]):
        x = blk.apply_block_full(self_p, x, cfg, "attn", positions)
        x = _cross_attention(cross_p, x, *_cross_kv(cross_p, enc_out, cfg),
                             cfg)
    x = blk.apply_norm(params["final_norm"], x, cfg)
    return lm_logits(params, cfg, x)


def prefill_cross_cache(params, cfg: ArchConfig, frames) -> dict:
    """The encoder pass and every decoder layer's cross keys and values,
    the decode-time constant: ``{"k", "v"}`` stacked ``(L, B, T, Kv,
    hd)``."""
    enc_out = encode(params, cfg, frames)
    kv = [_cross_kv(p, enc_out, cfg) for p in params["cross"]]
    return {"k": torch.stack([k for k, _ in kv]),
            "v": torch.stack([v for _, v in kv])}


def decode_encdec_body(params, cfg: ArchConfig, x, cache: dict, index: int):
    """The decoder's layers for one token: self-attention against the
    self cache (written in place), then cross-attention."""
    cross = cache["cross"]
    for i, (self_p, cross_p, self_c) in enumerate(zip(
            params["layers"][0], params["cross"], cache["self"][0])):
        x, _ = blk.apply_block_decode(self_p, x, cfg, "attn", self_c, index)
        x = _cross_attention(cross_p, x, cross["k"][i], cross["v"][i], cfg)
    return x


__all__ = ["LmParams", "init_lm", "embed_tokens", "lm_logits",
           "hidden_forward", "forward", "init_cache", "decode_step",
           "encode", "forward_encdec", "prefill_cross_cache",
           "decode_encdec_body", "init_encoder", "init_cross_stack",
           "dtype_of", "POS_DEC"]
