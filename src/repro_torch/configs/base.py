"""Architecture configuration schema, the port's own copy.

Counterpart of ``repro/configs/base.py``: the fields, ``LM_SHAPES``,
``shape_by_name``, ``resolved_head_dim``, ``padded_vocab_size``,
``pattern``, ``strategy_for``, ``n_params()``, ``active_params()`` and
``reduced()`` are the same, so a config names the same shapes in both
packages. The sharding fields (parallelism and its per-shape overrides,
the microbatch target) are read by the dry run (``launch/dryrun.py``,
``sharding/``), which places each architecture on the production meshes
by arithmetic; ``remat`` is read by the train step; ``scan_layers`` has
no meaning in the port, whose layers are a Python loop.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ShapeSpec:
    """One workload shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeSpec:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


@dataclass(frozen=True)
class MoeConfig:
    n_experts: int = 0
    n_experts_per_token: int = 0
    n_shared_experts: int = 0
    d_ff: int = 0  # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    partition: str = "ep"
    partition_decode: str = ""


@dataclass(frozen=True)
class MlaConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # one kind per layer; () means all "attn".
    # kinds: attn | attn_local | rglru | mlstm | slstm | dense_ffn_attn
    layer_pattern: tuple = ()

    # attention variants
    qk_norm: bool = False
    qkv_bias: bool = False
    window: int = 0  # sliding-window size for attn_local (0 = full)
    attn_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rms_offset: float = 0.0  # gemma-style (1 + w) scaling
    act: str = "silu"
    post_norms: bool = False  # gemma3 post-attn / post-ffn norms
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)

    moe: MoeConfig = field(default_factory=MoeConfig)
    mla: MlaConfig | None = None

    # recurrent families
    lru_width: int = 0
    conv1d_width: int = 4
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.334

    # encoder-decoder (audio) / frontend stubs (vlm, audio)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    frontend: str = ""  # "" | "vision_stub" | "audio_stub"
    n_frontend_tokens: int = 0

    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "full"
    scan_layers: bool = True
    microbatch_target_tokens: int = 16_384
    parallelism: str = "tp_sp"
    parallelism_overrides: tuple = ()
    shapes: tuple = ("train_4k", "prefill_32k", "decode_32k")

    source: str = ""  # provenance note

    def strategy_for(self, shape_name: str) -> str:
        for name, strat in self.parallelism_overrides:
            if name == shape_name:
                return strat
        return self.parallelism

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a multiple of 256; the pad ids are masked
        in ``lm_logits`` and never predicted."""
        return -(-self.vocab_size // 256) * 256

    @property
    def pattern(self) -> tuple:
        if self.layer_pattern:
            assert len(self.layer_pattern) == self.n_layers, self.name
            return self.layer_pattern
        return ("attn",) * self.n_layers

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d + (0 if self.tie_embeddings else v * d)
        for kind in self.pattern:
            if kind in ("attn", "attn_local", "dense_ffn_attn"):
                if self.mla is not None:
                    m = self.mla
                    total += d * m.q_lora_rank
                    total += m.q_lora_rank * self.n_heads * (
                        m.qk_nope_head_dim + m.qk_rope_head_dim)
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank * self.n_heads * (
                        m.qk_nope_head_dim + m.v_head_dim)
                    total += self.n_heads * m.v_head_dim * d
                else:
                    total += d * self.n_heads * hd  # wq
                    total += 2 * d * self.n_kv_heads * hd  # wk, wv
                    total += self.n_heads * hd * d  # wo
                if kind == "dense_ffn_attn" or self.moe.n_experts == 0:
                    total += 3 * d * self.d_ff
                else:
                    mo = self.moe
                    total += d * mo.n_experts
                    total += mo.n_experts * 3 * d * mo.d_ff
                    total += mo.n_shared_experts * 3 * d * mo.d_ff
            elif kind == "rglru":
                w = self.lru_width
                total += 2 * d * w + w * d
                total += self.conv1d_width * w + 4 * w
                total += 3 * d * self.d_ff
            elif kind == "mlstm":
                di = int(self.d_model * self.mlstm_proj_factor)
                total += 2 * d * di + di * d + 3 * di * di // 4
            elif kind == "slstm":
                total += 4 * d * d + int(2 * d * d * self.slstm_proj_factor)
            total += 2 * d  # norms
        return int(total)

    def active_params(self) -> int:
        """Active (per-token) parameters: an MoE counts its top-k experts
        only."""
        if self.moe.n_experts == 0:
            return self.n_params()
        mo = self.moe
        n_moe_layers = sum(
            1 for k in self.pattern
            if k in ("attn", "attn_local") and self.moe.n_experts > 0)
        inactive = (mo.n_experts - mo.n_experts_per_token)
        return int(self.n_params()
                   - n_moe_layers * inactive * 3 * self.d_model * mo.d_ff)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU tests (the reference's own
        reduction, field for field)."""
        pat = self.pattern
        n = min(len(pat), max(2, _pattern_period(pat)))
        kw = dict(
            n_layers=n,
            layer_pattern=pat[:n],
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            lru_width=64 if self.lru_width else 0,
            n_frontend_tokens=8 if self.n_frontend_tokens else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            dtype="float32",
            param_dtype="float32",
            remat="none",
            window=min(self.window, 8) if self.window else 0,
        )
        if self.moe.n_experts:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, n_experts_per_token=2,
                n_shared_experts=min(self.moe.n_shared_experts, 1), d_ff=32,
                capacity_factor=2.0)
        if self.mla is not None:
            kw["mla"] = MlaConfig(kv_lora_rank=32, q_lora_rank=48,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8,
                                  v_head_dim=16)
        return self.replace(**kw)


def _pattern_period(pat: tuple) -> int:
    """Smallest p with pat[i] == pat[i % p] for all i (<= len(pat))."""
    for p in range(1, len(pat)):
        if all(pat[i] == pat[i % p] for i in range(len(pat))):
            return p
    return len(pat)


__all__ = ["ArchConfig", "MoeConfig", "MlaConfig", "ShapeSpec", "LM_SHAPES",
           "shape_by_name"]
