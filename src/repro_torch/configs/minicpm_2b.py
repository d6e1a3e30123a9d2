"""MiniCPM-2B [arXiv:2404.06395] — dense llama-like, MHA, WSD schedule."""
from repro_torch.configs.base import ModelConfig, ATTN_GLOBAL

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,          # full MHA per assignment (GQA kv=36)
    d_ff=5760,
    vocab_size=122753,
    head_dim=64,
    mlp_type="swiglu",
    pattern=(ATTN_GLOBAL,),
    rope_theta=10000.0,
    tie_embeddings=True,
    scale_embed=True,          # MiniCPM scales embeddings / residuals (mu-p style)
    schedule="wsd",            # Warmup-Stable-Decay, the paper's signature schedule
    supports_long_context=False,
    long_context_note="pure full attention; long_500k decode skipped per spec",
    citation="arXiv:2404.06395",
)
