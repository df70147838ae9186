"""recurrentgemma-9b [hybrid]: 38 blocks d=4096, pattern
(RG-LRU, RG-LRU, local-attn) — 1 attention per 2 recurrent blocks — 16H
MQA (kv=1, 256-dim heads, window 2048), d_ff=12288, vocab=256000.
[arXiv:2402.19427; unverified]

lru_width = d_model (4096); gate projections are full WxW (the released
model uses block-diagonal). Gemma-style (1+w) RMSNorm + sqrt(d) embed
scaling.
long_500k included: hybrid recurrent + local attention is sub-quadratic.
"""
from repro_torch.configs.base import ArchConfig

_PATTERN = tuple(
    "attn_local" if (i % 3) == 2 else "rglru" for i in range(38))

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    layer_pattern=_PATTERN,
    window=2048,
    lru_width=4096,
    conv1d_width=4,
    rms_offset=1.0,
    embed_scale=True,
    act="gelu",
    tie_embeddings=True,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="[arXiv:2402.19427; unverified]",
)
