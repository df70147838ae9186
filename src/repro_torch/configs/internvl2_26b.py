"""internvl2-26b [vlm]: InternLM2-20B backbone, 48L d=6144 48H (GQA kv=8)
d_ff=16384 vocab=92553 + InternViT vision frontend. [arXiv:2404.16821; hf]

The vision tower is a stub: the batch carries precomputed patch embeddings
(B, 256, d_model), which are prepended to the token embeddings
(``data.lm_pipeline.TokenStream`` draws them). long_500k skipped: pure full
attention.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    frontend="vision_stub",
    n_frontend_tokens=256,
    act="silu",
    parallelism_overrides=(("train_4k", "fsdp"),),
    tie_embeddings=False,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="[arXiv:2404.16821; hf]",
)
