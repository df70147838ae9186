"""Decoder-only language model: embedding, layer stack, final norm, head.

Counterpart of the decoder-only parts of ``repro/models/lm.py``
(``init_lm``, ``embed_tokens``, ``lm_logits``, ``hidden_forward``,
``forward``, ``init_cache``, ``decode_step``). The parameters are an
``LmParams`` module indexed like the reference's dict (``params["embed"]``,
``params["layers"]``, ``params["final_norm"]``, ``params["lm_head"]`` when
untied). The encoder-decoder and vision-stub front ends are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import resolve
from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as blk
from repro_torch.models.common import dense_init, embed_init, frozen


def dtype_of(name: str) -> torch.dtype:
    """``torch.bfloat16`` for ``"bfloat16"``, and so on."""
    return getattr(torch, name)


class LmParams(nn.Module):
    """The model's parameters, frozen: ``embed (V_pad, d)``, ``layers``
    (one ``nn.ModuleList`` of blocks per run), ``final_norm`` and, for an
    untied head, ``lm_head (d, V_pad)``."""

    def __init__(self, embed: torch.Tensor, layers: nn.ModuleList,
                 final_norm: dict, lm_head: torch.Tensor | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = layers
        self.final_norm = frozen(final_norm)
        self.lm_head = (None if lm_head is None else
                        nn.Parameter(lm_head, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return getattr(self, name, None) is not None


def _check(cfg: ArchConfig) -> None:
    if cfg.is_encoder_decoder or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and front-end stubs are not "
            "ported yet")


def init_lm(generator: torch.Generator | int, cfg: ArchConfig,
            device=None) -> LmParams:
    """Random weights, drawn from ``generator`` (or a new generator seeded
    with an int, on ``device``: cuda unless given). The embedding is scaled
    by ``d ** -0.5`` (unit-variance tied logits at init), over the padded
    vocabulary."""
    _check(cfg)
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
    return LmParams(embed, layers,
                    blk._norm_params(cfg, dtype, generator.device), head)


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
    (B, S)``; returns ``h (B, S, D)``."""
    _check(cfg)
    x = embed_tokens(params, cfg, batch["tokens"])
    B, S, _ = x.shape
    x = blk.apply_stack_full(params["layers"], x, cfg,
                             _positions(B, S, x.device))
    return blk.apply_norm(params["final_norm"], x, cfg)


def forward(params, cfg: ArchConfig, batch):
    """Logits ``(B, S, V_pad)`` of ``batch["tokens"] (B, S)``."""
    return lm_logits(params, cfg, hidden_forward(params, cfg, batch))


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> dict:
    _check(cfg)
    return {"self": blk.init_stack_cache(cfg, batch, max_len,
                                         dtype_of(cfg.dtype), device)}


def decode_step(params, cfg: ArchConfig, tokens, cache: dict, index: int):
    """One new token per sequence against a filled cache. ``tokens (B,
    1)``; returns ``(logits (B, 1, V_pad), cache)``, the cache updated in
    place at position ``index``."""
    x = embed_tokens(params, cfg, tokens)
    x, _ = blk.apply_stack_decode(params["layers"], x, cfg, cache["self"],
                                  index)
    x = blk.apply_norm(params["final_norm"], x, cfg)
    return lm_logits(params, cfg, x), cache


__all__ = ["LmParams", "init_lm", "embed_tokens", "lm_logits",
           "hidden_forward", "forward", "init_cache", "decode_step",
           "dtype_of"]
