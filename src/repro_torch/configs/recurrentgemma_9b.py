"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427] — RG-LRU + local attention,
pattern 2 recurrent : 1 local-attn, MQA kv=1, window 2048."""
from repro_torch.configs.base import ATTN_LOCAL, BLOCK_RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,             # 38 = 12x(rglru,rglru,local) + (rglru,rglru)
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,            # MQA on the attention blocks
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    mlp_type="geglu",
    pattern=(BLOCK_RGLRU, BLOCK_RGLRU, ATTN_LOCAL),
    sliding_window=2048,
    lru_width=4096,
    conv_kernel=4,
    rope_theta=10000.0,
    tie_embeddings=True,
    scale_embed=True,
    supports_long_context=True,
    long_context_note="RG-LRU recurrence + 2048-window attention; long_500k runs",
    citation="arXiv:2402.19427",
)
