"""qwen2-1.5b [dense]: 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

QKV bias, 128-dim heads, SwiGLU, tied embeddings. [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="silu",
    parallelism_overrides=(("train_4k", "fsdp"),),
    tie_embeddings=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="[arXiv:2407.10671; hf]",
)
