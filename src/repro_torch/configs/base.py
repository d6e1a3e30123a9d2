"""Model architecture config of the PyTorch port.

A copy of `repro.configs.base.ModelConfig` (and the layer-kind constants),
kept here so the port never imports the JAX package. Only the fields and
methods the ported serving path reads are carried: `reduced()`,
`layer_kinds`, `padded_vocab_size` and `param_count()` compute exactly what
their JAX counterparts compute.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer kinds used in repeating block patterns.
ATTN_GLOBAL = "global"    # full causal attention
ATTN_LOCAL = "local"      # sliding-window causal attention
BLOCK_MLSTM = "mlstm"     # xLSTM matrix-memory block
BLOCK_SLSTM = "slstm"     # xLSTM scalar-memory block
BLOCK_RGLRU = "rglru"     # RG-LRU recurrent block (Griffin)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_expert: int
    router_aux_loss: float = 0.01


@dataclass(frozen=True)
class ModelConfig:
    """One architecture at its full published size; `.reduced()` derives the
    smoke variant of the same family."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    head_dim: Optional[int] = None   # default: d_model // num_heads
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None     # tanh soft-cap on attention logits
    final_softcap: Optional[float] = None    # tanh soft-cap on LM-head logits
    sliding_window: Optional[int] = None     # window for ATTN_LOCAL layers
    rope_theta: float = 10000.0
    pattern: Tuple[str, ...] = (ATTN_GLOBAL,)
    mlp_type: str = "swiglu"                 # swiglu | geglu | gelu
    moe: Optional[MoEConfig] = None
    lru_width: Optional[int] = None          # RG-LRU recurrence width
    conv_kernel: int = 4                     # temporal-conv width in recurrent blocks
    proj_factor: float = 2.0                 # xLSTM up-projection factor
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    tie_embeddings: bool = True
    scale_embed: bool = False                # gemma-style sqrt(d_model) embed scaling
    encoder_layers: int = 0                  # >0 => encoder-decoder (whisper)
    encoder_seq: int = 1500
    modality: str = "text"                   # text | vision | audio
    frontend_tokens: int = 0
    # Pad the vocab up to a multiple (0 = off); padded logits are masked.
    pad_vocab_multiple: int = 0
    supports_long_context: bool = False
    long_context_note: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: num_heads % num_kv_heads != 0")

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kinds, pattern tiled to num_layers."""
        reps = -(-self.num_layers // len(self.pattern))
        return (self.pattern * reps)[: self.num_layers]

    @property
    def padded_vocab_size(self) -> int:
        if self.pad_vocab_multiple <= 0:
            return self.vocab_size
        m = self.pad_vocab_multiple
        return -(-self.vocab_size // m) * m

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                vocab: int = 512, seq_cap: int = 128) -> "ModelConfig":
        """Smoke-test variant of the same family (same rule as the JAX
        package's `ModelConfig.reduced`)."""
        d_model = min(d_model, 512)
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        head_dim = max(8, d_model // heads)
        moe = None
        if self.moe is not None:
            k = min(self.moe.experts_per_token, 2)
            moe = MoEConfig(num_experts=4, experts_per_token=k,
                            d_expert=max(8, d_model // 2),
                            router_aux_loss=self.moe.router_aux_loss)
        pattern = tuple(dict.fromkeys(self.pattern))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            pattern=pattern,
            num_layers=max(num_layers, len(pattern)),
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            d_ff=0 if self.d_ff == 0 else max(16, d_model * 2),
            vocab_size=min(self.vocab_size, vocab),
            sliding_window=None if self.sliding_window is None else min(self.sliding_window, seq_cap // 2),
            lru_width=None if self.lru_width is None else d_model,
            moe=moe,
            encoder_layers=0 if self.encoder_layers == 0 else 2,
            encoder_seq=min(self.encoder_seq, 64),
            frontend_tokens=min(self.frontend_tokens, 16),
        )

    def param_count(self) -> int:
        return sum(self._param_terms().values())

    def _param_terms(self) -> dict:
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        terms = {"embed": self.vocab_size * d}
        if not self.tie_embeddings:
            terms["lm_head"] = self.vocab_size * d
        attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * hd
        mlp = (3 if self.mlp_type in ("swiglu", "geglu") else 2) * d * self.d_ff
        n_attn = n_mlp = n_rec = n_moe = 0
        for kind in self.layer_kinds:
            if kind in (ATTN_GLOBAL, ATTN_LOCAL):
                n_attn += 1
                if self.moe is not None:
                    n_moe += 1
                elif self.d_ff > 0:
                    n_mlp += 1
            elif kind == BLOCK_RGLRU:
                n_rec += 1
                n_mlp += 1
            elif kind in (BLOCK_MLSTM, BLOCK_SLSTM):
                n_rec += 1
        terms["attn"] = n_attn * attn
        terms["mlp"] = n_mlp * mlp
        if self.moe is not None:
            e = self.moe
            expert = (3 if self.mlp_type in ("swiglu", "geglu") else 2) * d * e.d_expert
            terms["moe_experts"] = n_moe * e.num_experts * expert
            terms["moe_router"] = n_moe * d * e.num_experts
        if n_rec:
            if self.family == "ssm":
                inner = int(d * self.proj_factor)
                per = d * inner * 2 + 3 * inner * inner // max(self.num_heads, 1) + inner * d
            else:
                w = self.lru_width or d
                per = 2 * d * w + 3 * w + w * self.conv_kernel + w * d + 2 * w * w
            terms["recurrent"] = n_rec * per
        if self.encoder_layers:
            terms["encoder"] = self.encoder_layers * (attn * 2 + mlp)
        terms["norms"] = 2 * self.num_layers * d + d
        return terms
