"""Recurrent blocks: the RG-LRU (RecurrentGemma), the mLSTM and the sLSTM
(xLSTM), and the causal depthwise conv1d in front of the first two.

Counterpart of ``repro/models/recurrent.py``. Each block has a
full-sequence form, which returns ``(y, state)``, and a one-token decode
step, which writes every leaf of its state (``h``, ``conv``, ``C``,
``n``, ``m``, ``c``) in place with ``copy_`` and returns ``(y, state)``,
as ``attention_decode`` writes its KV cache.

* RG-LRU: a diagonal linear recurrence ``h_t = a_t h_{t-1} + g_t``,
  evaluated in chunks of 256 steps with the carry ``h`` looped across
  them. Inside a chunk a log-step (Hillis-Steele) scan combines ``(log
  a, g)`` pairs as the reference's ``lax.associative_scan`` does, ``(a1 +
  a2, b2 + exp(a2) b1)``; only the tree of the sums differs. The closed
  form ``exp(L_t) sum exp(-L_s) g_s`` is not used: over 256 steps
  ``exp(-L_s)`` reaches about e^27 and loses float32 precision.
* mLSTM: the stabilised chunkwise form (chunk 256): quadratic products
  inside a chunk, the ``(C, n, m)`` carry across chunks. The last chunk
  is padded as in the reference, ``log_i`` with -1e30, so a padded step
  adds nothing.
* sLSTM: its gates read the previous ``h`` through per-head recurrent
  matrices, so it runs one step a token, by the architecture's nature.
  The input projection of every step is one product over the sequence.

The recurrences are plain PyTorch: in the reference they are XLA scans
and jnp, not Pallas kernels. In a sharded program each recurrence runs on
its rank's own blocks (``sharding.activation.on_blocks``), the batch over
the data axes and the channels (RG-LRU) or heads (mLSTM, sLSTM) over
``"model"`` where they divide, the time axis whole: nothing inside a time
loop communicates, as in the program XLA builds for the reference's
``lax.scan`` bodies. The projections around them are DTensor ops, their
weights whole over the data axes (``gathered``). On ``meta`` under a
counter the sLSTM's token loop is counted by one middle step times its
trip count (``analysis.flops.loop_steps``). Gates and states are float32 whatever
the model's dtype; ``lam``, ``w_if``, ``b_if`` and ``b_zifo`` are
float32 leaves in a bf16 model, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.analysis.flops import loop_steps
from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import act_fn, dense_init, frozen, uniform
from repro_torch.sharding.activation import (BATCH_AXES, Out, constrain,
                                            gathered, on_blocks, placed_like,
                                            reduce_partial, unflatten_last)

_CHUNK = 256
_NEG = -1e30
_gelu = act_fn("gelu")  # the tanh form, jax.nn.gelu's default
_SEQ_WHOLE = (BATCH_AXES, None, None)  # the SP all-gather: the time axis whole
_CHANNELS = (BATCH_AXES, None, "model")  # (B, S, C): channels over "model"


def _softplus(x):
    """``jnp.logaddexp(x, 0)``, the form of ``jax.nn.softplus``."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _log_sigmoid(x):
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -_softplus(-x)


# ---------------------------------------------------------------------------
# temporal (causal, depthwise) conv1d
# ---------------------------------------------------------------------------


def init_conv1d(generator: torch.Generator, width: int, channels: int,
                dtype) -> nn.ParameterDict:
    return frozen({
        "w": dense_init((width, channels), dtype, generator,
                        scale=width ** -0.5),
        "b": torch.zeros((channels,), dtype=dtype, device=generator.device),
    })


def conv1d_full(p, x):
    """Causal depthwise conv of ``x (B, S, C)``: tap ``i`` reads the input
    ``width - 1 - i`` steps back; the sum runs in the taps' order, in the
    activation dtype. A sharded program's taps are DTensor ops on the
    ``(batch, channel)`` blocks, the time axis whole, each delayed input
    made on the rank's own block: the gradient of ``x`` then sums the
    taps' and its other uses' terms in the order a one-process program
    does, and nothing communicates."""
    width = p["w"].shape[0]
    x = constrain(x, _CHANNELS)
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + _delayed(x, width - 1 - i) * p["w"][i]
    return out + p["b"]


def _delayed(x, shift: int):
    """``x (B, S, C)`` ``shift`` steps later along the sequence, zeros
    first (on each rank's block: DTensor's ``F.pad`` has no sharding
    strategy in every PyTorch version)."""
    S = x.shape[1]
    return on_blocks(lambda t: F.pad(t, (0, 0, shift, 0))[:, :S], (x,),
                     (None,), (Out(0, (0, 1, 2)),))


def conv1d_step(p, x_t, state):
    """``x_t (B, 1, C)``; ``state (B, width - 1, C)``, the past inputs,
    shifted in place to take ``x_t``. Returns ``(y (B, 1, C), state)``."""
    # the past inputs' layout (a sharded program's token gathered over
    # the channels if they are split)
    window = torch.cat([state, placed_like(x_t, state)], dim=1)  # (B, w, C)
    y = torch.einsum("bwc,wc->bc", window, p["w"]) + p["b"]
    state.copy_(window[:, 1:])
    return y[:, None, :], state


def _conv_state(u_raw, width: int):
    """The last ``width - 1`` raw inputs of ``u_raw (B, S, C)`` (zeros
    before the first): the conv state a decode phase continues from."""
    cw, S = width - 1, u_raw.shape[1]
    return on_blocks(lambda u: F.pad(u, (0, 0, cw, 0))[:, S:S + cw],
                     (u_raw,), (_CHANNELS,), (Out(0, (0, 1, 2)),))


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------


def init_rglru_block(generator: torch.Generator, cfg: ArchConfig,
                     dtype) -> nn.Module:
    d, w = cfg.d_model, cfg.lru_width
    dev = generator.device
    # lam so that a = sigmoid(lam)^c covers [0.9, 0.999] (Griffin's init)
    c = 8.0
    u = 0.9 + (0.999 - 0.9) * uniform((w,), generator)
    lam = torch.log(u ** (1.0 / c) / (1.0 - u ** (1.0 / c)))
    return frozen({
        "w_in": dense_init((d, w), dtype, generator),
        "w_gate_in": dense_init((d, w), dtype, generator),
        "conv": init_conv1d(generator, cfg.conv1d_width, w, dtype),
        "w_rg": dense_init((w, w), dtype, generator),
        "b_rg": torch.zeros((w,), dtype=dtype, device=dev),
        "w_ig": dense_init((w, w), dtype, generator),
        "b_ig": torch.zeros((w,), dtype=dtype, device=dev),
        "lam": lam,
        "w_out": dense_init((w, d), dtype, generator),
    })


def _scan_chunk(la, g):
    """Inclusive scan of ``(la, g) (B, L, W)`` under ``(a1, b1) o (a2, b2)
    = (a1 + a2, b2 + exp(a2) b1)``, in log2(L) steps."""
    shift, L = 1, la.shape[1]
    while shift < L:
        carried = torch.exp(la[:, shift:]) * g[:, :-shift]
        g = torch.cat([g[:, :shift], g[:, shift:] + carried], dim=1)
        la = torch.cat([la[:, :shift], la[:, shift:] + la[:, :-shift]], dim=1)
        shift *= 2
    return la, g


def _rglru_scan(log_a, gx, h0=None):
    """``h_t = exp(log_a_t) h_{t-1} + gx_t`` over ``(B, S, W)`` from ``h0
    (B, W)`` (zeros where None), in chunks of ``_CHUNK`` steps. Returns
    ``(h_seq, h_last)``."""
    B, S, W = gx.shape
    h = gx.new_zeros((B, W)) if h0 is None else h0
    out = []
    for t0 in range(0, S, _CHUNK):
        la_cum, b_cum = _scan_chunk(log_a[:, t0:t0 + _CHUNK],
                                    gx[:, t0:t0 + _CHUNK])
        hs = torch.exp(la_cum) * h[:, None, :] + b_cum
        out.append(hs)
        h = hs[:, -1]
    return torch.cat(out, dim=1), h


def _rglru_gates(p, u):
    """``(r, i)``, the recurrence and input gates of ``u``, in f32. A
    sharded program's gate products are partial sums over the channels'
    split; the reference leaves them to XLA. Pinned: reduce-scattered onto
    the channels, the layout the scan takes (an all-reduce would move the
    whole products twice, a scatter onto the sequence would need an
    all-to-all before the scan)."""

    def gate(w, b):
        return torch.sigmoid((reduce_partial(
            torch.einsum("bsw,wv->bsv", u, gathered(w)), _CHANNELS)
            + b).float())

    return gate(p["w_rg"], p["b_rg"]), gate(p["w_ig"], p["b_ig"])


def rglru_block_full(p, x, cfg: ArchConfig, state=None):
    """Full-sequence Griffin recurrent block. ``x (B, S, D)``; returns
    ``(y, {"h", "conv"})``, the state a decode phase continues from. A
    sharded program's scan runs on each rank's ``(batch, W)`` block."""
    x = constrain(x, _SEQ_WHOLE)
    gate = _gelu(torch.einsum("bsd,dw->bsw", x, gathered(p["w_gate_in"])))
    u_raw = torch.einsum("bsd,dw->bsw", x, gathered(p["w_in"]))
    u = conv1d_full(p["conv"], u_raw)
    r, i = _rglru_gates(p, u)
    log_a = -8.0 * _softplus(p["lam"])[None, None, :] * r  # (B, S, W) f32
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gx = beta * (i * u.float())
    h0 = None if state is None else state["h"]
    hs, h_last = on_blocks(
        _rglru_scan, (log_a, gx, h0),
        (_CHANNELS, _CHANNELS, None if h0 is None else (BATCH_AXES, "model")),
        (Out(0, (0, 1, 2)), Out(0, (0, 2))))
    y = torch.einsum("bsw,wd->bsd", hs.to(x.dtype) * gate,
                     gathered(p["w_out"]))
    return y, {"h": h_last, "conv": _conv_state(u_raw, cfg.conv1d_width)}


def init_rglru_state(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    return {
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, cfg.lru_width),
                            dtype=dtype, device=device),
    }


def rglru_block_step(p, x_t, cfg: ArchConfig, state: dict):
    """One decode step. ``x_t (B, 1, D)``; ``state`` ``{"h", "conv"}`` is
    written in place."""
    # a sharded program's projections of the step's one token are partial
    # sums over the data axes (DTensor splits the token's features to meet
    # the weights' blocks rather than gather the weights); pinned to the
    # channel layout: reduce-scattered onto the batch
    gate = _gelu(constrain(torch.einsum("bsd,dw->bsw", x_t,
                                        p["w_gate_in"]), _CHANNELS))
    u = constrain(torch.einsum("bsd,dw->bsw", x_t, p["w_in"]), _CHANNELS)
    u, _ = conv1d_step(p["conv"], u, state["conv"])
    r, i = _rglru_gates(p, u)
    log_a = -8.0 * _softplus(p["lam"])[None, None, :] * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    h = a[:, 0] * state["h"] + (beta * (i * u.float()))[:, 0]
    state["h"].copy_(placed_like(h, state["h"]))
    y = torch.einsum("bsw,wd->bsd", h[:, None].to(x_t.dtype) * gate,
                     p["w_out"])
    return y, state


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block), stabilised chunkwise form
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg: ArchConfig):
    di = int(cfg.d_model * cfg.mlstm_proj_factor)
    return di, cfg.n_heads, di // cfg.n_heads


def init_mlstm_block(generator: torch.Generator, cfg: ArchConfig,
                     dtype) -> nn.Module:
    d = cfg.d_model
    di, nh, _ = _mlstm_dims(cfg)
    dev = generator.device
    return frozen({
        "w_up": dense_init((d, di), dtype, generator),
        "w_gate": dense_init((d, di), dtype, generator),
        "conv": init_conv1d(generator, cfg.conv1d_width, di, dtype),
        "wq": dense_init((di, di), dtype, generator),
        "wk": dense_init((di, di), dtype, generator),
        "wv": dense_init((di, di), dtype, generator),
        "w_if": dense_init((di, 2 * nh), torch.float32, generator),
        "b_if": torch.cat([  # input gate bias 0, forget gate bias open
            torch.zeros((nh,), dtype=torch.float32, device=dev),
            torch.linspace(3.0, 6.0, nh, dtype=torch.float32, device=dev)]),
        "skip": torch.ones((di,), dtype=dtype, device=dev),
        "w_down": dense_init((di, d), dtype, generator),
    })


def _mlstm_chunk(q, k, v, log_i, log_f, carry):
    """One stabilised chunk. ``q, k, v (B, H, L, Dh)``; gates ``(B, H,
    L)``; ``carry`` ``(C (B, H, Dh, Dh), n (B, H, Dh), m (B, H))``.
    Returns ``(h, carry)``."""
    L, Dh = q.shape[2], q.shape[3]
    scale = Dh ** -0.5
    b = torch.cumsum(log_f, dim=-1)  # inclusive cumulative log f
    C_p, n_p, m_p = carry

    # intra-chunk log weights D[t, s] = b_t - b_s + log_i_s (s <= t)
    Dm = b[..., :, None] - b[..., None, :] + log_i[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    Dm = torch.where(mask, Dm, -math.inf)
    m_intra = Dm.amax(dim=-1)
    m_inter = b + m_p[..., None]
    m_t = torch.clamp(torch.maximum(m_intra, m_inter), min=_NEG)

    S = torch.einsum("bhtd,bhsd->bhts", q, k) * scale
    W = torch.exp(Dm - m_t[..., None])
    h_num = torch.einsum("bhts,bhsd->bhtd", S * W, v)
    n_vec = torch.einsum("bhts,bhsd->bhtd", W, k)

    inter_w = torch.exp(m_inter - m_t)[..., None]
    h_num = h_num + inter_w * torch.einsum("bhde,bhte->bhtd", C_p, q) * scale
    n_vec = n_vec + inter_w * n_p[..., None, :]

    qn = torch.einsum("bhtd,bhtd->bht", q, n_vec) * scale
    denom = torch.maximum(qn.abs(), torch.exp(-m_t))
    h = h_num / denom[..., None]

    # the carry
    bL = b[..., -1]
    m_new = torch.maximum(bL + m_p,
                          (bL[..., None] - b + log_i).amax(dim=-1))
    w_s = torch.exp(bL[..., None] - b + log_i - m_new[..., None])
    decay = torch.exp(bL + m_p - m_new)
    C_new = (decay[..., None, None] * C_p
             + torch.einsum("bhsd,bhse->bhde", w_s[..., None] * v, k))
    n_new = decay[..., None] * n_p + torch.einsum("bhs,bhsd->bhd", w_s, k)
    return h, (C_new, n_new, m_new)


def _mlstm_qkv_gates(p, xc, up, nh: int, dh: int):
    """``q, k, v (B, S, nh, dh)`` in f32 and the gate pre-activations
    ``(log_i, log_f) (B, S, nh)``."""

    def heads(w, t):
        return unflatten_last(torch.einsum("bse,ef->bsf", t, gathered(w)),
                              (nh, dh)).float()

    # a sharded program's gate columns are a partial sum over the
    # channels' split; pinned: all-reduced (a few columns a token: one
    # collective, fewer bytes than a reduce-scatter and the gather the
    # heads' blocks would then need)
    gif = constrain(torch.einsum("bse,eg->bsg", xc.float(),
                                 gathered(p["w_if"])),
                    (BATCH_AXES, None, None)) + p["b_if"]
    return (heads(p["wq"], xc), heads(p["wk"], xc), heads(p["wv"], up),
            gif[..., :nh], _log_sigmoid(gif[..., nh:]))


def _mlstm_scan(q, k, v, log_i, log_f, C=None, n=None, m=None):
    """The chunkwise mLSTM over ``q, k, v (B, S, nh, dh)`` and gates ``(B,
    S, nh)`` from the carry ``(C, n, m)`` (the zero state where None):
    ``(h (B, S, nh, dh), C, n, m)``."""
    B, S, nh, dh = q.shape
    q, k, v, log_i, log_f = (t.transpose(1, 2)
                             for t in (q, k, v, log_i, log_f))
    chunk = min(_CHUNK, S)
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, pad), value=_NEG)
        log_f = F.pad(log_f, (0, pad))
    if C is None:
        carry = (q.new_zeros((B, nh, dh, dh)), q.new_zeros((B, nh, dh)),
                 q.new_full((B, nh), _NEG))
    else:
        carry = (C, n, m)
    hs = []
    for t0 in range(0, S + pad, chunk):
        sl = slice(t0, t0 + chunk)
        h, carry = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                log_i[..., sl], log_f[..., sl], carry)
        hs.append(h)
    return (torch.cat(hs, dim=2)[:, :, :S].transpose(1, 2),) + carry


_HEADS = (BATCH_AXES, None, "model")  # (B, S, nh, ...): heads over "model"


def mlstm_block_full(p, x, cfg: ArchConfig, state=None):
    """Full-sequence mLSTM block. ``x (B, S, D)``; returns ``(y, {"C", "n",
    "m", "conv"})``. A sharded program's chunk loop runs on each rank's
    ``(batch, heads)`` block."""
    B, S, _ = x.shape
    di, nh, dh = _mlstm_dims(cfg)
    x = constrain(x, _SEQ_WHOLE)
    up = torch.einsum("bsd,de->bse", x, gathered(p["w_up"]))
    z = torch.einsum("bsd,de->bse", x, gathered(p["w_gate"]))
    xc = F.silu(conv1d_full(p["conv"], up))
    carry = () if state is None else (state["C"], state["n"], state["m"])
    hs, C, n, m = on_blocks(
        _mlstm_scan, _mlstm_qkv_gates(p, xc, up, nh, dh) + carry,
        (_HEADS + (None,),) * 3 + (_HEADS,) * 2 + (
            (BATCH_AXES, "model", None, None), (BATCH_AXES, "model", None),
            (BATCH_AXES, "model"))[:len(carry)],
        (Out(0, (0, 1, 2, 3)), Out(0, (0, 2, None, None)),
         Out(0, (0, 2, None)), Out(0, (0, 2))))
    # over "model" as ``xc`` is, so the gradient reaches the heads' split
    # whole where the heads do not divide over it
    hs = constrain(hs.reshape(B, S, di), _CHANNELS)

    out = (hs.to(x.dtype) + p["skip"] * xc) * F.silu(z)
    y = torch.einsum("bse,ed->bsd", out, gathered(p["w_down"]))
    return y, {"C": C, "n": n, "m": m,
               "conv": _conv_state(up, cfg.conv1d_width)}


def init_mlstm_state(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    di, nh, dh = _mlstm_dims(cfg)
    return {
        "C": torch.zeros((batch, nh, dh, dh), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, nh, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, nh), _NEG, dtype=torch.float32,
                        device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, di), dtype=dtype,
                            device=device),
    }


def mlstm_block_step(p, x_t, cfg: ArchConfig, state: dict):
    """One decode step with O(1) state. ``x_t (B, 1, D)``; ``state`` is
    written in place."""
    B = x_t.shape[0]
    di, nh, dh = _mlstm_dims(cfg)
    # a sharded program's projections of the step's one token are partial
    # sums over the data axes (DTensor splits the token's features to meet
    # the weights' blocks rather than gather the weights); pinned to the
    # channel layout: reduce-scattered onto the batch
    up = constrain(torch.einsum("bsd,de->bse", x_t, p["w_up"]), _CHANNELS)
    z = constrain(torch.einsum("bsd,de->bse", x_t, p["w_gate"]), _CHANNELS)
    uc, _ = conv1d_step(p["conv"], up, state["conv"])
    xc = F.silu(uc)
    q, k, v, log_i, log_f = (
        t[:, 0] for t in _mlstm_qkv_gates(p, xc, up, nh, dh))
    # the state update on each rank's (batch, heads) block, as the full
    # form's chunk loop: its inputs pinned to the state's layout
    one = (BATCH_AXES, "model", None)
    h, C, n, m_new = on_blocks(
        _mlstm_update, (q, k, v, log_i, log_f, state["C"], state["n"],
                        state["m"]),
        (one,) * 3 + ((BATCH_AXES, "model"),) * 2
        + ((BATCH_AXES, "model", None, None), one, (BATCH_AXES, "model")),
        (Out(0, (0, 1, 2)), Out(5, (0, 1, 2, 3)), Out(6, (0, 1, 2)),
         Out(7, (0, 1))))
    state["C"].copy_(C)
    state["n"].copy_(n)
    state["m"].copy_(m_new)

    out = (h.reshape(B, 1, di).to(x_t.dtype) + p["skip"] * xc) * F.silu(z)
    return torch.einsum("bse,ed->bsd", out, p["w_down"]), state


def _mlstm_update(q, k, v, log_i, log_f, C_p, n_p, m_p):
    """One mLSTM step from the carry ``(C_p, n_p, m_p)``: ``q, k, v (B,
    H, Dh)``, gates ``(B, H)``; returns ``(h, C, n, m)``."""
    dh = q.shape[-1]
    m_new = torch.maximum(log_f + m_p, log_i)
    fw = torch.exp(log_f + m_p - m_new)[..., None]
    iw = torch.exp(log_i - m_new)[..., None]
    C = fw[..., None] * C_p + iw[..., None] * torch.einsum("bhd,bhe->bhde",
                                                           v, k)
    n = fw * n_p + iw * k
    scale = dh ** -0.5
    h_num = torch.einsum("bhde,bhe->bhd", C, q) * scale
    qn = torch.einsum("bhd,bhd->bh", q, n) * scale
    denom = torch.maximum(qn.abs(), torch.exp(-m_new))
    return h_num / denom[..., None], C, n, m_new


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory block): one step a token
# ---------------------------------------------------------------------------


def init_slstm_block(generator: torch.Generator, cfg: ArchConfig,
                     dtype) -> nn.ParameterDict:
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    dff = int(d * cfg.slstm_proj_factor) * 2
    dev = generator.device
    return frozen({
        "w_zifo": dense_init((d, 4 * d), dtype, generator),
        # per-head recurrent matrices (a block-diagonal recurrence)
        "r_zifo": dense_init((nh, dh, 4 * dh), dtype, generator,
                             scale=dh ** -0.5),
        "b_zifo": torch.cat([  # forget gate bias open
            torch.zeros((2 * d,), dtype=torch.float32, device=dev),
            torch.full((d,), 3.0, dtype=torch.float32, device=dev),
            torch.zeros((d,), dtype=torch.float32, device=dev)]),
        "w_ff1": dense_init((d, dff), dtype, generator),
        "w_ff2": dense_init((dff // 2, d), dtype, generator),
    })


def _slstm_gates(wx, h_prev, r_zifo, b_zifo):
    """``wx (B, 4, H, Dh)``, the step's input projection laid out
    gate-major, as in the reference; ``h_prev (B, H, Dh)`` f32; the
    recurrent matrices ``r_zifo (H, Dh, 4 Dh)`` (head-major ``(H, 4,
    Dh)`` terms) and the bias ``b_zifo (4, H, Dh)`` -> ``z, i~, f~, o~``
    each ``(B, H, Dh)`` f32."""
    B, _, nh, dh = wx.shape
    rh = torch.einsum("bhd,hde->bhe", h_prev, r_zifo.to(h_prev.dtype))
    wx = wx.transpose(1, 2)  # (B, H, 4, Dh)
    rh = rh.reshape(B, nh, 4, dh)
    g = (wx + rh).float().transpose(1, 2) + b_zifo
    return g[:, 0], g[:, 1], g[:, 2], g[:, 3]


def _slstm_step(wx, st, r_zifo, b_zifo):
    c, n, h, m = st
    z, it, ft, ot = _slstm_gates(wx, h, r_zifo, b_zifo)
    z = torch.tanh(z)
    o = torch.sigmoid(ot)
    log_f = _log_sigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def init_slstm_state(cfg: ArchConfig, batch: int, device) -> dict:
    nh = cfg.n_heads
    shape = (batch, nh, cfg.d_model // nh)
    st = {name: torch.zeros(shape, dtype=torch.float32, device=device)
          for name in ("c", "n", "h")}
    st["m"] = torch.full(shape, _NEG, dtype=torch.float32, device=device)
    return st


def _slstm_ffn(p, hs):
    """The GLU feed-forward (proj factor 4/3, paired gates)."""
    u, g = torch.einsum("bsd,de->bse", hs,
                        gathered(p["w_ff1"])).chunk(2, dim=-1)
    return torch.einsum("bse,ed->bsd", u * _gelu(g), gathered(p["w_ff2"]))


def _slstm_scan(wx, r_zifo, b_zifo, c=None, n=None, h=None, m=None):
    """One step a token over ``wx (B, S, 4, H, Dh)`` from the state ``(c,
    n, h, m)`` (``init_slstm_state``'s where None): ``(h_seq (B, S, H,
    Dh), c, n, h, m)``."""
    B, S, _, nh, dh = wx.shape
    if c is None:
        z = wx.new_zeros((B, nh, dh), dtype=torch.float32)
        c, n, h, m = z, z, z, torch.full_like(z, _NEG)
    hs, carry = loop_steps(
        lambda wx_t, st: _slstm_step(wx_t, st, r_zifo, b_zifo), wx,
        (c, n, h, m), emit=2)
    return (hs,) + carry


def slstm_block_full(p, x, cfg: ArchConfig, state=None):
    """One step a token over ``x (B, S, D)``; returns ``(y, {"c", "n",
    "h", "m"})``. A sharded program's token loop runs on each rank's
    ``(batch, heads)`` block."""
    B, S, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    x = constrain(x, _SEQ_WHOLE)
    wx = torch.einsum("bsd,de->bse", x, gathered(p["w_zifo"]))  # (B, S, 4D)
    st = () if state is None else tuple(state[k] for k in "cnhm")
    one = (BATCH_AXES, "model", None)
    hs, c, n, h, m = on_blocks(
        _slstm_scan, (unflatten_last(wx, (4, nh, dh)), p["r_zifo"],
                      p["b_zifo"].reshape(4, nh, dh)) + st,
        ((BATCH_AXES, None, None, "model", None), ("model", None, None),
         (None, "model", None)) + (one,) * len(st),
        (Out(0, (0, 1, 3, 4)),) + (Out(0, (0, 3, 4)),) * 4)
    hs = hs.reshape(B, S, d).to(x.dtype)
    return _slstm_ffn(p, hs), {"c": c, "n": n, "h": h, "m": m}


def slstm_block_step(p, x_t, cfg: ArchConfig, state: dict):
    """One decode step. ``x_t (B, 1, D)``; ``state`` is written in
    place."""
    B = x_t.shape[0]
    nh = cfg.n_heads
    dh = cfg.d_model // nh
    wx = torch.einsum("bd,de->be", x_t[:, 0], gathered(p["w_zifo"]))
    one = (BATCH_AXES, "model", None)
    new = on_blocks(
        lambda w, r, b, *st: _slstm_step(w, st, r, b),
        (unflatten_last(wx, (4, nh, dh)), p["r_zifo"],
         p["b_zifo"].reshape(4, nh, dh)) + tuple(state[k] for k in "cnhm"),
        ((BATCH_AXES, None, "model", None), ("model", None, None),
         (None, "model", None)) + (one,) * 4, (Out(0, (0, 2, 3)),) * 4)
    for name, t in zip(("c", "n", "h", "m"), new):
        state[name].copy_(t)
    hs = new[2].reshape(B, 1, cfg.d_model).to(x_t.dtype)
    return _slstm_ffn(p, hs), state


__all__ = [
    "init_conv1d", "conv1d_full", "conv1d_step",
    "init_rglru_block", "rglru_block_full", "rglru_block_step",
    "init_rglru_state",
    "init_mlstm_block", "mlstm_block_full", "mlstm_block_step",
    "init_mlstm_state",
    "init_slstm_block", "slstm_block_full", "slstm_block_step",
    "init_slstm_state",
]
