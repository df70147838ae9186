"""Shared model-building primitives: init, norms, rotary embeddings, acts.

Counterpart of ``repro/models/common.py``. Parameters keep the JAX shapes
and are applied with ``torch.einsum``; the initialisers draw from an
explicit ``torch.Generator`` (they cannot give ``jax.random``'s numbers:
tests carry the JAX weights across with ``serving.convert``). On the
``meta`` device, where no generator exists, ``META_DRAWS`` stands in for
one: the initialisers then draw nothing and return empty ``meta``
tensors of the same shapes and dtypes (the dry run's models).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding.activation import grad_like, replicated_like


class ParamTree(nn.Module):
    """A dict node that holds both tensors and sub-dicts (the MoE layer's
    router and expert tensors beside its shared MLP), indexed like a dict
    in its insertion order."""

    def __init__(self, tree: dict):
        super().__init__()
        self._names = list(tree)
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(
                    v, requires_grad=False))
            else:
                self.add_module(k, v if isinstance(v, nn.Module)
                                else frozen(v))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def keys(self):
        return list(self._names)

    def items(self):
        return [(k, self[k]) for k in self._names]


def frozen(tree) -> nn.Module:
    """A nested dict of tensors as frozen parameters: a dict whose values
    are all tensors becomes an ``nn.ParameterDict``, one of dicts only an
    ``nn.ModuleDict``, one that mixes them a ``ParamTree``. No parameter
    requires a gradient as built, so serving builds no autograd graph; a
    trainer turns them on with ``requires_grad_(True)``."""
    is_t = [isinstance(v, torch.Tensor) for v in tree.values()]
    if all(is_t):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    if any(is_t):
        return ParamTree(tree)
    return nn.ModuleDict({k: v if isinstance(v, nn.Module) else frozen(v)
                          for k, v in tree.items()})


class _MetaDraws:
    """The generator of a ``meta`` build: ``device`` is ``meta`` and the
    initialisers draw nothing from it (``torch.Generator(device="meta")``
    does not exist)."""

    device = torch.device("meta")


META_DRAWS = _MetaDraws()


def uniform(shape, generator) -> torch.Tensor:
    """f32 uniform draws on [0, 1) on ``generator``'s device (an empty
    ``meta`` tensor from ``META_DRAWS``)."""
    if generator is META_DRAWS:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.rand(shape, generator=generator, device=generator.device,
                      dtype=torch.float32)


def dense_init(shape, dtype, generator: torch.Generator,
               scale: float | None = None) -> torch.Tensor:
    """Truncated normal on [-2, 2] at fan-in scale (``1/sqrt(fan_in)``
    unless ``scale``), drawn in f32 by the inverse CDF, cast to
    ``dtype``."""
    if generator is META_DRAWS:
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = math.prod(shape[:-1]) if len(shape) >= 2 else (
        shape[0] if shape else 1)
    std = scale if scale is not None else fan_in ** -0.5
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    u = lo + (1.0 - 2.0 * lo) * u  # uniform on [Phi(-2), Phi(2)]
    x = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return (x.clamp_(-2.0, 2.0) * std).to(dtype)


def expert_init(shape, dtype, generator: torch.Generator) -> torch.Tensor:
    """``dense_init`` of a stacked expert tensor ``(E, fan, out)`` at the
    reference's fan-in, which counts the expert axis (``E * fan``), drawn
    one expert at a time: the f32 draw's temporaries never exceed one
    expert's size (deepseek-v2's ``w_gate`` is 5 GB in f32 whole)."""
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    if generator is META_DRAWS:
        return out
    std = math.prod(shape[:-1]) ** -0.5
    for e in range(shape[0]):
        out[e] = dense_init(shape[1:], dtype, generator, scale=std)
    return out


def embed_init(shape, dtype, generator: torch.Generator) -> torch.Tensor:
    if generator is META_DRAWS:
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32).to(dtype)


def rms_norm(x, weight, eps: float = 1e-6, *, offset: float = 0.0):
    """RMSNorm in f32; gemma-style ``(1 + w)`` via ``offset=1``. A sharded
    program's cotangent of the output is placed as the output is
    (``grad_like``) before the norm's backward takes it."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return grad_like((y * (offset + weight.float())).to(x.dtype))


def layer_norm(x, weight, bias, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return grad_like((y * weight.float() + bias.float()).to(x.dtype))


_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
    "relu": F.relu,
}


def act_fn(name: str):
    return _ACTS[name]


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None):
    """Inverse frequencies for RoPE, ``(head_dim // 2,)`` f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotate the interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` (not
    the rotate-half layout). ``x (B, S, H, D)``, ``positions (B, S)``
    int; f32 angles and math, cast back."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * inv  # (B, S, D/2)
    sin = replicated_like(torch.sin(ang)[:, :, None, :], x)
    cos = replicated_like(torch.cos(ang)[:, :, None, :], x)
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def sinusoidal_positions(n_pos: int, dim: int, device=None):
    """The sin / cos table ``(n_pos, dim)`` in f32: whisper's encoder
    positions (the caller casts it to the activation dtype)."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (10000.0 ** (2.0 * idx / dim))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def softcap(logits, cap: float | None):
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


__all__ = ["frozen", "ParamTree", "META_DRAWS", "uniform", "dense_init",
           "expert_init", "embed_init",
           "rms_norm", "layer_norm", "act_fn", "rope_frequencies",
           "apply_rope", "sinusoidal_positions", "softcap"]
