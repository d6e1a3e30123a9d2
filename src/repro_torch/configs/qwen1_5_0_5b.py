"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — dense, QKV bias, MHA kv=16."""
from repro_torch.configs.base import ModelConfig, ATTN_GLOBAL

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,             # Qwen's signature QKV bias
    mlp_type="swiglu",
    pattern=(ATTN_GLOBAL,),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    supports_long_context=False,
    long_context_note="pure full attention; long_500k decode skipped per spec",
    citation="hf:Qwen/Qwen1.5-0.5B",
)
