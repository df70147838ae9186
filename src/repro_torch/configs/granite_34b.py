"""granite-34b [dense]: 88L d=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

Llama-architecture code model: SwiGLU, RMSNorm, RoPE, multi-query attention,
tied embeddings. [arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    act="silu",
    parallelism_overrides=(("train_4k", "fsdp"),),
    tie_embeddings=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="[arXiv:2405.04324; hf]",
)
