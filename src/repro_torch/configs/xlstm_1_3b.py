"""xLSTM 1.3B [arXiv:2405.04517] — sLSTM + mLSTM blocks (xLSTM[7:1]),
d_ff=0 (the block's up-projection plays the MLP role), 4 heads,
recurrent O(1) decode state -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, BLOCK_MLSTM, BLOCK_SLSTM

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                    # per assignment: blocks carry their own projections
    vocab_size=50304,
    head_dim=512,              # inner = d_model*proj_factor over 4 heads... set by block
    proj_factor=2.0,
    conv_kernel=4,
    # xLSTM[7:1]: one sLSTM block per 7 mLSTM blocks (48 = 6 groups of 8)
    pattern=(BLOCK_MLSTM,) * 7 + (BLOCK_SLSTM,),
    norm="layernorm",
    tie_embeddings=True,
    supports_long_context=True,
    long_context_note="recurrent state decode, O(1) per token; long_500k runs",
    citation="arXiv:2405.04517",
)
