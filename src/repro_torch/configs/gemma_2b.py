"""Gemma 2B [arXiv:2403.08295] — GeGLU, head_dim=256, MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig, ATTN_GLOBAL

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,            # MQA
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    mlp_type="geglu",
    pattern=(ATTN_GLOBAL,),
    rope_theta=10000.0,
    tie_embeddings=True,
    scale_embed=True,
    supports_long_context=False,
    long_context_note="pure full attention; long_500k decode skipped per spec",
    citation="arXiv:2403.08295",
)
