"""Grok-1 314B [hf:xai-org/grok-1] — MoE, 8 experts top-2, attn logit cap."""
from repro_torch.configs.base import ModelConfig, MoEConfig, ATTN_GLOBAL

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    mlp_type="geglu",
    attn_softcap=30.0,         # grok caps attention logits (30 * tanh(x/30))
    final_softcap=None,
    pattern=(ATTN_GLOBAL,),
    rope_theta=10000.0,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=8, experts_per_token=2, d_expert=32768),
    supports_long_context=False,
    long_context_note="full attention; long_500k decode skipped per spec",
    citation="hf:xai-org/grok-1",
)
