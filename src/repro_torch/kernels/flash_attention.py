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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 256
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
    rc = lib.rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, Hkv, D, int(q.dtype == torch.bfloat16), int(causal),
        int(window or 0), float(scale), float(softcap or 0.0), stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
