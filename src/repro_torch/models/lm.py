"""Language models: the decoder-only LM and the encoder-decoder.

Counterpart of ``repro/models/lm.py``: ``init_lm``, ``embed_tokens``,
``lm_logits``, ``hidden_forward``, ``forward``, ``init_cache``,
``decode_step``, the encoder-decoder's ``encode``, ``forward_encdec``,
``prefill_cross_cache``, ``decode_encdec_body``, and for training the
loss: ``cross_entropy`` (with the z-loss), ``chunked_cross_entropy`` and
``train_step_loss``, whose gradient is the train step:

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
``params["pos_embed_dec"]`` for an encoder-decoder). They are frozen
(``requires_grad=False``) as built; a trainer turns them on with
``params.requires_grad_(True)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_m
from repro_torch.models import blocks as blk
from repro_torch.models.common import (META_DRAWS, dense_init, embed_init,
                                       frozen, sinusoidal_positions)
from repro_torch.sharding.activation import (BATCH_AXES, constrain,
                                            gathered, is_dtensor,
                                            reduce_partial, replicated_like)

POS_DEC = 32_768  # learned decoder positions: the largest assigned shape
Z_LOSS_COEF = 1e-4
# past this many logit elements the loss runs in sequence chunks, so the
# f32 (B, S, V) logits exist for one chunk at a time
_CE_CHUNK_LIMIT = 64 * 1024 * 1024
_CE_CHUNK = 512
# the parameters a leading layer axis stacks in the reference's tree: a
# run's (``layers``, ``encoder``: name.run.layer...) or the cross stack's
# (``cross``: name.layer...)
_STACKED = {"layers": 2, "encoder": 2, "cross": 1}


def dtype_of(name: str) -> torch.dtype:
    """``torch.bfloat16`` for ``"bfloat16"``, and so on."""
    return getattr(torch, name)


class LmParams(nn.Module):
    """The model's parameters (frozen as built): ``embed (V_pad, d)``,
    ``layers`` (one ``nn.ModuleList`` of blocks per run), ``final_norm``;
    for an untied head ``lm_head (d, V_pad)``; for an encoder-decoder
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

    def reference_leaves(self) -> dict:
        """The leaves of the reference's ``init_lm`` tree by dotted path
        (``"embed"``, ``"layers.0.attn.wq"``, ``"cross.ln.w"``, ...), in
        this module's order: a parameter alone, or for a stacked leaf the
        list of its layers' parameters (the reference's leading layer
        axis)."""
        out = {}
        for name, t in self.named_parameters():
            parts = name.split(".")
            keep = _STACKED.get(parts[0])
            if keep is None:
                out[name] = t
            else:
                key = ".".join(parts[:keep] + parts[keep + 1:])
                out.setdefault(key, []).append(t)
        return out


def _frozen_tensor(t):
    return None if t is None else nn.Parameter(t, requires_grad=False)


def init_lm(generator: torch.Generator | int, cfg: ArchConfig,
            device=None) -> LmParams:
    """Random weights, drawn from ``generator`` (or a new generator seeded
    with an int, on ``device``: cuda unless given). The embedding is scaled
    by ``d ** -0.5`` (unit-variance tied logits at init), over the padded
    vocabulary. An encoder-decoder also gets its encoder, its per-layer
    cross-attention and its learned decoder positions.

    On ``device="meta"`` the seed is unused: every leaf is an empty
    ``meta`` tensor (no memory, nothing drawn) of a real init's shape,
    dtype and name, the dry run's stand-in for the weights."""
    if not isinstance(generator, torch.Generator):
        dev = resolve(device)
        generator = (META_DRAWS if dev.type == "meta" else
                     torch.Generator(device=dev).manual_seed(int(generator)))
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
    # a sharded table is gathered over its feature dim first (DTensor's
    # masked lookup mis-sizes its mask when the table's features and the
    # tokens' rows shard over one axis)
    table = constrain(params["embed"], ("model", None))
    x = F.embedding(tokens, table).to(dtype_of(cfg.dtype))
    if cfg.embed_scale:  # sqrt(d) rounded to the activation dtype first
        # a vocab-sharded lookup is a partial sum (one rank's row, zeros
        # elsewhere) that the scale cannot take: reduce-scattered onto the
        # features first (an exact sum), then gathered below
        x = reduce_partial(x, 2)
        x = x * x.new_full((), cfg.d_model ** 0.5)
    # batch over the data axes (sequence over data where batch cannot)
    return constrain(x, (BATCH_AXES, None, None))


def lm_logits(params, cfg: ArchConfig, x):
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    # a sharded program's head: the sequence whole (the SP all-gather) and
    # the weight whole over the data axes, its vocab over "model"
    x = constrain(x, (BATCH_AXES, None, None))
    logits = torch.einsum("bsd,dv->bsv", x, gathered(head).to(x.dtype))
    if cfg.padded_vocab_size != cfg.vocab_size:
        # pad ids are never predicted
        if is_dtensor(logits):  # a vocab-sharded block: the same fill
            # (a partial sum, where the head's features are split,
            # reduce-scattered first to the layout pinned below)
            logits = reduce_partial(logits, (BATCH_AXES, None, "model"))
            pad = torch.arange(cfg.padded_vocab_size,
                               device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(replicated_like(pad, logits), -1e30)
        else:  # an explicit fill: one op on every device, meta included
            logits[..., cfg.vocab_size:].fill_(-1e30)
    # the f32-bound logits stay vocab-sharded in a sharded program
    return constrain(logits, (BATCH_AXES, None, "model"))


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def hidden_forward(params, cfg: ArchConfig, batch):
    """Trunk only: embed -> layer stack -> final norm. ``batch["tokens"]
    (B, S_txt)``, and for the vision stub optionally ``batch
    ["patch_embeds"] (B, Np, D)``, prepended; returns ``(h (B, S, D),
    aux)``, ``aux`` the MoE load-balancing losses (f32, 0 without an
    MoE)."""
    x = embed_tokens(params, cfg, batch["tokens"])
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    x, aux = blk.apply_stack_full(params["layers"], x, cfg,
                                  _positions(B, S, x.device))
    return blk.apply_norm(params["final_norm"], x, cfg), aux


def forward(params, cfg: ArchConfig, batch):
    """Logits ``(B, S, V_pad)`` of ``batch`` (see ``hidden_forward``)."""
    return lm_logits(params, cfg, hidden_forward(params, cfg, batch)[0])


def _vocab_sharded(logits) -> bool:
    return is_dtensor(logits) and any(
        p.is_shard(logits.dim() - 1) for p in logits.placements)


def _lse(logits):
    """``logsumexp`` over the last (vocab) dimension. On vocab-sharded
    DTensor logits it is taken as ``torch.logsumexp`` computes it, a max
    and a sum of exponentials, each reduced over the vocab's ranks (a
    partial max and a partial sum), so no rank gathers the logits."""
    if not _vocab_sharded(logits):
        return torch.logsumexp(logits, dim=-1)
    # the max and the sum all-reduced explicitly: a token's row whole on
    # every vocab rank, so the gradient comes back vocab-sharded (left to
    # DTensor, a build may scatter them over the sequence instead, and the
    # head's backward then gathers the logits' gradient)
    m = reduce_partial(logits.detach().amax(dim=-1, keepdim=True), None)
    return torch.log(reduce_partial(torch.sum(torch.exp(logits - m), dim=-1),
                                    None)) + m[..., 0]


def _gold(logits, labels):
    """Each token's label logit, ``logits (B, S, V)`` at ``labels (B, S)``:
    a gather. On DTensor logits each rank gathers from its own block (its
    rows, and where the vocab is sharded its vocab block, zero where the
    label lies in another's), and the vocab blocks' values are summed: one
    nonzero term, exact."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, V = logits.device_mesh, logits.shape[-1]
    vocab = [i for i, p in enumerate(logits.placements)
             if p.is_shard(logits.dim() - 1)]
    rows = tuple(Replicate() if i in vocab else p
                 for i, p in enumerate(logits.placements))
    local = logits.to_local()
    lab = replicated_like(labels, logits)
    lab = lab.redistribute(mesh, rows).to_local().long()
    block, v0 = V, 0
    for i in vocab:  # mesh order: the vocab's row-major split
        block //= mesh.size(i)
        v0 += mesh.get_local_rank(i) * block
    idx = lab - v0
    inside = (idx >= 0) & (idx < local.shape[-1])
    g = torch.gather(local, -1, idx.clamp(0, local.shape[-1] - 1)[..., None])
    g = torch.where(inside, g[..., 0], torch.zeros((), dtype=g.dtype,
                                                    device=g.device))
    part = tuple(Partial() if i in vocab else p for i, p in enumerate(rows))
    g = DTensor.from_local(g, mesh, part, run_check=False)
    return g.redistribute(mesh, rows) if vocab else g


def cross_entropy(logits, labels, mask=None):
    """Mean token cross entropy with the z-loss, in f32: ``lse - gold +
    Z_LOSS_COEF * lse ** 2`` a token, ``gold`` the label's logit (a
    gather: the same value as the reference's masked reduce), the mean
    over ``mask`` where given (``sum / max(sum(mask), 1)``)."""
    logits_f = logits.float()
    lse = _lse(logits_f)
    gold = _gold(logits_f, labels)
    per_tok = (lse - gold) + Z_LOSS_COEF * lse ** 2
    if mask is None:
        return torch.mean(per_tok)
    mask = mask.float()
    return torch.sum(per_tok * mask) / torch.clamp(torch.sum(mask), min=1.0)


def chunked_cross_entropy(params, cfg: ArchConfig, h, labels, mask=None):
    """``cross_entropy(lm_logits(params, cfg, h), labels, mask)`` in
    ``_CE_CHUNK``-token chunks of the sequence, each under
    ``torch.utils.checkpoint`` when grad is enabled, so the f32 logits
    exist for one chunk at a time, forward and backward."""
    B, S, _ = h.shape
    c = min(_CE_CHUNK, S)
    mask = (replicated_like(torch.ones((B, S), dtype=torch.float32,
                                       device=h.device), h)
            if mask is None else mask.float())

    def chunk(hx, lx, mx):
        logits = lm_logits(params, cfg, hx).float()
        lse = _lse(logits)
        gold = _gold(logits, lx)
        return torch.sum((lse - gold + Z_LOSS_COEF * lse ** 2) * mx)

    run = chunk
    if torch.is_grad_enabled() and h.requires_grad:
        run = lambda *a: checkpoint(chunk, *a, use_reentrant=False)  # noqa: E731
    tot = replicated_like(torch.zeros((), dtype=torch.float32,
                                      device=h.device), h)
    cnt = replicated_like(torch.zeros((), dtype=torch.float32,
                                      device=h.device), h)
    for s0 in range(0, S, c):
        mx = mask[:, s0:s0 + c]
        # each chunk's partial sums (over the data axes' rows) all-reduced
        # explicitly before they join the replicated totals
        tot = tot + reduce_partial(run(h[:, s0:s0 + c], labels[:, s0:s0 + c],
                                       mx), None)
        cnt = cnt + reduce_partial(torch.sum(mx), None)
    return tot / torch.clamp(cnt, min=1.0)


def train_step_loss(params, cfg: ArchConfig, batch):
    """The scalar loss of one batch (``tokens``, ``labels``, optionally
    ``mask``; the front ends' ``patch_embeds`` / ``frames``): its gradient
    is the train step. The vision stub's patch positions carry no loss;
    the encoder-decoder's goes through ``forward_encdec`` (whose aux is
    the reference's constant 0); past ``_CE_CHUNK_LIMIT`` logit elements
    the loss is chunked; the MoE loss is added."""
    labels, mask = batch["labels"], batch.get("mask")
    if cfg.is_encoder_decoder:
        return cross_entropy(forward_encdec(params, cfg, batch), labels,
                             mask)
    h, aux = hidden_forward(params, cfg, batch)
    if cfg.frontend == "vision_stub" and "patch_embeds" in batch:
        h = h[:, batch["patch_embeds"].shape[1]:]
    if h.shape[0] * h.shape[1] * cfg.padded_vocab_size > _CE_CHUNK_LIMIT:
        return chunked_cross_entropy(params, cfg, h, labels, mask) + aux
    return cross_entropy(lm_logits(params, cfg, h), labels, mask) + aux


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
    x = x + replicated_like(
        sinusoidal_positions(T, cfg.d_model, x.device).to(x.dtype), x)
    return blk.apply_stack_full(params["encoder"], x, _encoder_cfg(cfg),
                                _positions(B, T, x.device), causal=False)[0]


_HEADS_TP = attn_m._HEADS_TP  # batch over the data axes, heads over "model"


def _cross_attention(p, x, k, v, cfg: ArchConfig):
    """``x (B, Sq, D)`` queries over the encoder's ``k, v (B, Skv, Kv,
    hd)``, non-causal, with the residual. A sharded program's q, k and v
    reach ``flash_attention`` over batch and heads, each rank's encoder
    frames whole (a cache's k and v are pinned there too), and the
    output projection's partial sum is reduce-scattered to the residual's
    SP layout."""
    h = constrain(blk.apply_norm(p["ln"], x, cfg), (BATCH_AXES, None, None))
    q = constrain(torch.einsum("bsd,dhk->bshk", h,
                               gathered(p["attn"]["wq"], (2,))), _HEADS_TP)
    if cfg.qkv_bias:
        q = q + gathered(p["attn"]["bq"], (1,))
    out = kops.flash_attention(q.contiguous(), constrain(k, _HEADS_TP),
                               constrain(v, _HEADS_TP), causal=False)
    out = constrain(out, _HEADS_TP)
    return x + constrain(torch.einsum("bshk,hkd->bsd", out,
                                      gathered(p["attn"]["wo"], (1,))),
                         blk.SP_SPEC)


def _cross_kv(p, enc_out, cfg: ArchConfig):
    enc_out = constrain(enc_out, (BATCH_AXES, None, None))
    k = constrain(torch.einsum("bsd,dhk->bshk", enc_out,
                               gathered(p["attn"]["wk"], (2,))), _HEADS_TP)
    v = constrain(torch.einsum("bsd,dhk->bshk", enc_out,
                               gathered(p["attn"]["wv"], (2,))), _HEADS_TP)
    if cfg.qkv_bias:
        k = k + gathered(p["attn"]["bk"], (1,))
        v = v + gathered(p["attn"]["bv"], (1,))
    return k.contiguous(), v.contiguous()


def forward_encdec(params, cfg: ArchConfig, batch):
    """The teacher-forced encoder-decoder pass: logits ``(B, S, V_pad)`` of
    ``batch["tokens"] (B, S)`` given ``batch["frames"] (B, T, D)``. Each
    decoder layer (its self-attention block, then cross-attention) is one
    unit of ``blk.remat``, as the reference's scan body."""
    enc_out = encode(params, cfg, batch["frames"])
    x = embed_tokens(params, cfg, batch["tokens"])
    B, S, _ = x.shape
    # the used rows whole over the data axes first (the table's features
    # are split there; left to DTensor, the add's layout depends on the
    # build)
    x = x + gathered(params["pos_embed_dec"][:S]).to(x.dtype)
    positions = _positions(B, S, x.device)
    if len(params["layers"]) != 1:
        raise ValueError("the encoder-decoder's decoder must be one run")

    def layer(self_p, cross_p, x, enc_out):
        x = blk.apply_block_full(self_p, x, cfg, "attn", positions)[0]
        return _cross_attention(cross_p, x,
                                *_cross_kv(cross_p, enc_out, cfg), cfg)

    for self_p, cross_p in zip(params["layers"][0], params["cross"]):
        x = blk.remat(layer, cfg, self_p, x)(self_p, cross_p, x, enc_out)
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
           "hidden_forward", "forward", "cross_entropy",
           "chunked_cross_entropy", "train_step_loss", "Z_LOSS_COEF",
           "init_cache", "decode_step",
           "encode", "forward_encdec", "prefill_cross_cache",
           "decode_encdec_body", "init_encoder", "init_cross_stack",
           "dtype_of", "POS_DEC"]
