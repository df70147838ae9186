"""xlstm-125m [ssm]: 12 blocks d=768 4H, vocab=50304, no separate FFN
(d_ff=0): mLSTM blocks (matrix memory, chunkwise-parallel) with periodic
sLSTM blocks (scalar memory, sequential scan) at a 5:1 ratio.
[arXiv:2405.04517; unverified]

long_500k included: linear-time recurrence, O(1) decode state.
"""
from repro_torch.configs.base import ArchConfig

_PATTERN = tuple(
    "slstm" if (i % 6) == 5 else "mlstm" for i in range(12))

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    layer_pattern=_PATTERN,
    mlstm_proj_factor=2.0,
    slstm_proj_factor=1.334,
    conv1d_width=4,
    act="gelu",
    tie_embeddings=False,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="[arXiv:2405.04517; unverified]",
)
