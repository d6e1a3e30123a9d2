"""OLMoE-1B-7B [arXiv:2409.02060] — MoE, 64 experts top-8, d_expert=1024."""
from repro_torch.configs.base import ModelConfig, MoEConfig, ATTN_GLOBAL

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,                 # per-expert FFN width
    vocab_size=50304,
    head_dim=128,
    mlp_type="swiglu",
    pattern=(ATTN_GLOBAL,),
    rope_theta=10000.0,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=64, experts_per_token=8, d_expert=1024),
    supports_long_context=False,
    long_context_note="full attention; long_500k decode skipped per spec",
    citation="arXiv:2409.02060",
)
