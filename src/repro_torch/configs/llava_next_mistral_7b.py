"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

VLM: the vision tower (CLIP-ViT-L + anyres tiling) is a stub — the caller
supplies precomputed patch embeddings as `batch["patch_embeds"]` (anyres:
base 576 tokens + up to 4 tiles -> 2880 tokens), which the model's 2-layer
projector maps to d_model. The Mistral-7B language backbone is complete.
"""
from repro_torch.configs.base import ModelConfig, ATTN_GLOBAL

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,            # GQA
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    mlp_type="swiglu",
    pattern=(ATTN_GLOBAL,),    # mistral-v0.2 backbone: no sliding window
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    modality="vision",
    frontend_tokens=2880,      # anyres: 576 base + 4x576 tiles
    supports_long_context=False,
    long_context_note="full attention backbone; long_500k decode skipped per spec",
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
