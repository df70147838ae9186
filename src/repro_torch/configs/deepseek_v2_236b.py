"""deepseek-v2-236b [moe]: 60L d=5120 128H, MLA (kv_lora=512), MoE with
2 shared + 160 routed experts top-6 (expert d_ff=1536), vocab=102400.
[arXiv:2405.04434; hf]

Layer 0 is a dense FFN (d_ff=12288) per the released config; layers 1-59
are MoE. MLA decode runs the *absorbed* form: the KV cache holds only the
(512 + 64)-dim latents.
"""
from repro_torch.configs.base import ArchConfig, MlaConfig, MoeConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,  # dense layer-0 FFN width
    vocab_size=102400,
    head_dim=192,  # qk_nope (128) + qk_rope (64)
    layer_pattern=("dense_ffn_attn",) + ("attn",) * 59,
    mla=MlaConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoeConfig(n_experts=160, n_experts_per_token=6, n_shared_experts=2,
                  d_ff=1536, partition="ep"),
    act="silu",
    tie_embeddings=False,
    microbatch_target_tokens=8_192,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="[arXiv:2405.04434; hf]",
)
