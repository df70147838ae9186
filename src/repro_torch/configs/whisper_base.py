"""whisper-base [audio]: enc-dec, 6L encoder + 6L decoder, d=512 8H (MHA)
d_ff=2048 vocab=51865, LayerNorm + GELU + attention biases.
[arXiv:2212.04356; unverified]

The conv/mel front end is a stub: the batch carries precomputed frame
embeddings (B, 1500, 512) straight into the encoder
(``data.lm_pipeline.TokenStream`` draws them).
Decoder uses learned positions (table sized to the 32k assigned shapes —
the backbone spec governs, not whisper's 448-token context).
long_500k skipped: enc-dec audio backbone, not a long-context family.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    is_encoder_decoder=True,
    n_encoder_layers=6,
    frontend="audio_stub",
    n_frontend_tokens=1500,
    norm="layernorm",
    qkv_bias=True,
    act="gelu",
    tie_embeddings=True,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    source="[arXiv:2212.04356; unverified]",
)
