"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.

QK-norm (per-head RMSNorm on q/k), no QKV bias, 128-dim heads, SwiGLU,
tied embeddings. [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="silu",
    parallelism_overrides=(("train_4k", "fsdp"),),
    tie_embeddings=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="[hf:Qwen/Qwen3-8B; hf]",
)
