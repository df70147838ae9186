"""gemma3-1b [dense]: 26L d=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

5:1 local:global attention (window 512 on the local layers; the global
layers use the 1M-theta RoPE), 256-dim heads, QK-norm, GeGLU, gemma-style
(1 + w) RMSNorm with post-norms, tied and sqrt(d)-scaled embeddings.
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import ArchConfig

_PATTERN = tuple(
    "attn" if (i % 6) == 5 else "attn_local" for i in range(26))

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    layer_pattern=_PATTERN,
    qk_norm=True,
    window=512,
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    rms_offset=1.0,
    post_norms=True,
    embed_scale=True,
    act="gelu",
    parallelism_overrides=(("train_4k", "fsdp"),),
    tie_embeddings=True,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="[hf:google/gemma-3-1b-pt; unverified]",
)
