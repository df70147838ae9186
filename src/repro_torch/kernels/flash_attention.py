"""Online-softmax attention: wrapper of ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention.py::flash_attention``, the LM
substrate's full-sequence attention (``models/attention.py::
attention_full``): causal masking, a sliding window, a tanh logit cap and
GQA by kv-head index, at right-aligned positions. bf16 runs both products
on the tensor cores (wgmma, TMA-fed, P split in two bf16 parts so that
P.V stays f32); f32 runs f32 FMAs on the CUDA cores. Both keep the running
max, denominator and accumulator in registers, skip the key tiles no row
of a 64-row query tile can see, and launch once per call. See the source
for the design and bound.

On a CPU tensor the wrapper runs the plain version (``ref.flash_attention``);
on a CUDA tensor it launches the kernel or raises.
``flash_attention.launches`` counts kernel launches.

``flash_attention_bwd`` is the gradient, in PyTorch on either device: the
reference has no backward kernel to port (its Pallas call has no
``custom_vjp``; off the TPU it differentiates the plain jnp version). It
recomputes the f32 scores a block of query rows at a time (at most
``limit`` scores a (batch, head) live) and forms ``dV = P^T dO``, ``dP =
dO V^T``, ``dS = P * (dP - rowsum(P * dP))`` (masked, then through the
softcap's ``1 - tanh^2``), ``dQ = dS K * scale``, ``dK = dS^T Q * scale``,
summing each kv head's query group (GQA). ``rowsum(P * dP)`` is
``rowsum(dO * O)`` of the exact output; it is taken from the recomputed
f32 ``P`` rather than from the forward's output, which a bf16 call has
rounded: through that rounding ``dQ`` and ``dK`` drift by thousands of
bf16 ulps where ``dP`` and the row sum nearly cancel, and this way stay
within a few ulps of autograd through the plain version.
``ops.flash_attention`` pairs it with the forward in a
``torch.autograd.Function``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 256
# score elements a (batch, head) past which the plain versions work in
# blocks: the CPU forward (``ops``) and the backward's query blocks
DENSE_SCORE_LIMIT = 2048 * 2048
_DTYPES = (torch.float32, torch.bfloat16)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention kernel: {what}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None,
                    softcap: float | None = None) -> torch.Tensor:
    """``q (B, Sq, H, D)``, ``k, v (B, Skv, Hkv, D)`` -> ``(B, Sq, H, D)``
    in q's dtype. ``scale`` defaults to ``D ** -0.5``; ``window`` and
    ``softcap`` of ``None`` (or 0) mean none."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, softcap=softcap)
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           "(B, S, H, D) operands")
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    _check(k.shape == v.shape and k.shape[0] == B and k.shape[3] == D,
           "k and v (B, Skv, Hkv, D) matching q")
    _check(q.dtype in _DTYPES, "bfloat16 or float32 only")
    _check(k.dtype == q.dtype and v.dtype == q.dtype, "one dtype")
    for t in (k, v):
        _check(t.device == q.device, "all tensors on one CUDA device")
    for t in (q, k, v):
        _check(t.is_contiguous(), "contiguous operands")
    _check(1 <= D <= MAX_HEAD_DIM, f"head dim 1..{MAX_HEAD_DIM}")
    _check(Hkv >= 1 and H % Hkv == 0, "H % Hkv == 0")
    _check(Skv >= 1 and B <= 65535 and H <= 65535,
           "Skv >= 1, B and H <= 65535")
    _check(window is None or window >= 0, "window >= 0")
    _check(softcap is None or softcap >= 0, "softcap >= 0")
    scale = scale if scale is not None else 1.0 / D ** 0.5
    lib = _build.load()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):  # the launch goes to the current device
        rc = lib.rt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, Hkv, D, int(q.dtype == torch.bfloat16), int(causal),
            int(window or 0), float(scale), float(softcap or 0.0), stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, dout, *, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None,
                        softcap: float | None = None,
                        limit: int = DENSE_SCORE_LIMIT):
    """``(dq, dk, dv)`` of ``flash_attention(q, k, v, ...)`` for the
    output cotangent ``dout (B, Sq, H, D)``, each in its operand's dtype.
    The scores are recomputed in f32 with the forward's masks at
    right-aligned positions, ``max(1, limit // Skv)`` query rows at a
    time; each kv head's queries (its group, then the rows) are one
    batch of plain products ``(B * Hkv, rep * rows, Skv)``."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / D ** 0.5
    softcap = softcap or None
    window = window or None
    heads = lambda t: t.float().transpose(1, 2).reshape(  # noqa: E731
        B * Hkv, Skv, D)
    kf, vf = heads(k), heads(v)
    dq = torch.empty_like(q)
    dk = torch.zeros((B * Hkv, Skv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    bq = max(1, limit // Skv)
    for q0 in range(0, Sq, bq):
        n = min(bq, Sq - q0)
        # (B, n, Hkv, rep, D) -> (B * Hkv, rep * n, D)
        grouped = lambda t: t[:, q0:q0 + n].float().reshape(  # noqa: E731
            B, n, Hkv, rep, D).permute(0, 2, 3, 1, 4).reshape(
                B * Hkv, rep * n, D)
        qg, dog = grouped(q), grouped(dout)
        s = torch.bmm(qg, kf.transpose(1, 2)).mul_(scale)
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        dropped = ~ref._attn_mask(Sq, Skv, causal, window, q.device, q0, 0,
                                  n, Skv)
        rows = lambda x: x.view(B * Hkv, rep, n, Skv)  # noqa: E731
        rows(s).masked_fill_(dropped, ref._NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        dv += torch.bmm(p.transpose(1, 2), dog)
        dp = torch.bmm(dog, vf.transpose(1, 2))
        delta = (p * dp).sum(-1, keepdim=True)
        ds = dp.sub_(delta).mul_(p)
        rows(ds).masked_fill_(dropped, 0.0)
        del p, dp
        if softcap is not None:
            ds.mul_(1.0 - t * t)
        ds.mul_(scale)
        dq[:, q0:q0 + n] = torch.bmm(ds, kf).view(B, Hkv, rep, n, D).permute(
            0, 3, 1, 2, 4).reshape(B, n, H, D).to(q.dtype)
        dk += torch.bmm(ds.transpose(1, 2), qg)
    back = lambda t, like: t.view(B, Hkv, Skv, D).transpose(  # noqa: E731
        1, 2).to(like.dtype).contiguous()
    return dq, back(dk, k), back(dv, v)
