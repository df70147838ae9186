"""mixtral-8x22b [moe]: 56L d=6144 48H (GQA kv=8), MoE 8 experts top-2
(d_ff=16384 each), vocab=32768, sliding-window attention (4096).
[arXiv:2401.04088; hf]

Token-choice top-2 with sort-based capacity dispatch (``partition="tp"``;
on one card ``"ep"`` and ``"tp"`` are the same computation).
"""
from repro_torch.configs.base import ArchConfig, MoeConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,  # == expert d_ff; dense layers unused
    vocab_size=32768,
    head_dim=128,
    layer_pattern=("attn_local",) * 56,
    window=4096,
    moe=MoeConfig(n_experts=8, n_experts_per_token=2, d_ff=16384,
                  partition="tp"),
    act="silu",
    microbatch_target_tokens=8_192,
    tie_embeddings=False,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="[arXiv:2401.04088; hf]",
)
