"""Gemma-2 9B [arXiv:2408.00118] — local/global alternating attention,
logit soft-capping, GeGLU, GQA kv=8, head_dim=256.
"""
from repro_torch.configs.base import ModelConfig, ATTN_LOCAL, ATTN_GLOBAL

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    mlp_type="geglu",
    pattern=(ATTN_LOCAL, ATTN_GLOBAL),   # alternate local(4096) / global
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    rope_theta=10000.0,
    tie_embeddings=True,
    scale_embed=True,
    supports_long_context=True,
    long_context_note=(
        "long_500k decode runs with the documented variant: global layers fall "
        "back to the 4096 sliding window beyond 32k context (block-local "
        "serving mode), making decode sub-quadratic. Recorded in DESIGN.md §5."),
    citation="arXiv:2408.00118",
)
