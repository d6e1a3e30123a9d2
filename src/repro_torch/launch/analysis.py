"""Analytic executed-FLOPs / executed-bytes model for the roofline table,
the JAX package's `launch/analysis.py` line for line (held bitwise by
tests/test_torch_launch.py).

It mirrors what the JAX package's `impl="jnp"` path executes: dense-mode
MoE counts all E experts, and windowed layers still count every padded kv
block, because that path enforces the window by masking. The port's flash
prefill kernel skips the tiles outside the window and above the diagonal,
so a measured step can take less time than this model's compute term.
The dry-run (launch/dryrun.py) records the model beside the FLOP counter
of its meta trace, which counts the matmuls the port's `impl="torch"` step
runs.

Conventions: 1 MAC = 2 FLOPs; train = fwd + remat-recompute + 2x bwd = 4x
forward FLOPs of the layer stack (remat over layers);
embeddings/gathers are counted as bytes, not FLOPs.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, BLOCK_MLSTM,
                                      BLOCK_RGLRU, BLOCK_SLSTM, InputShape,
                                      ModelConfig)


def _pad_to(x: int, c: int) -> int:
    return -(-x // c) * c


def model_flops(cfg, shape) -> float:
    """Closed-form MODEL_FLOPS: 6*N*D train (N = active params), 2*N*D for
    prefill, 2*N per decoded token."""
    n_active = cfg.active_param_count()
    toks = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * toks
    if shape.kind == "prefill":
        return 2.0 * n_active * toks
    return 2.0 * n_active * shape.global_batch   # one token per sequence


def loop_trip_count(cfg) -> int:
    return max(cfg.num_layers // len(cfg.pattern), 1)


@dataclass
class FlopsBreakdown:
    attn_proj: float = 0.0
    attn_sdpa: float = 0.0
    mlp: float = 0.0
    moe: float = 0.0
    recurrent: float = 0.0
    head: float = 0.0
    encoder: float = 0.0
    frontend: float = 0.0

    @property
    def total(self) -> float:
        return (self.attn_proj + self.attn_sdpa + self.mlp + self.moe
                + self.recurrent + self.head + self.encoder + self.frontend)


def forward_flops(cfg: ModelConfig, B: int, Sq: int, Skv: int, *,
                  kv_chunk: int = 1024, q_chunk: int = 512,
                  moe_mode: str = "dense", long_window=None,
                  with_head: bool = True) -> FlopsBreakdown:
    """One forward pass: B sequences of Sq new tokens against Skv context."""
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    fb = FlopsBreakdown()
    toks = B * Sq

    # padded SDPA extents (our impl computes full padded blocks, mask only)
    sq_p = _pad_to(Sq, min(q_chunk, Sq))
    glu = cfg.mlp_type in ("swiglu", "geglu")
    mlp_f = (6 if glu else 4) * d * cfg.d_ff

    for kind in cfg.layer_kinds:
        if kind in (ATTN_GLOBAL, ATTN_LOCAL):
            cap = Skv
            if kind == ATTN_LOCAL and cfg.sliding_window:
                cap = min(Skv, cfg.sliding_window) if Sq == 1 else Skv
            if long_window is not None and kind == ATTN_GLOBAL and Sq == 1:
                cap = min(Skv, long_window)
            skv_p = _pad_to(cap, min(kv_chunk, cap))
            fb.attn_proj += toks * 2 * d * (nq * hd + 2 * nkv * hd + nq * hd)
            fb.attn_sdpa += B * sq_p * skv_p * nq * hd * 4
            if cfg.is_encdec:   # cross attention to encoder frames
                fb.attn_proj += toks * 2 * d * (nq * hd + nq * hd)
                fb.attn_sdpa += B * sq_p * _pad_to(cfg.encoder_seq, 1024) * nq * hd * 4
            if cfg.moe is not None:
                e = cfg.moe
                exp_f = (6 if glu else 4) * d * e.d_expert
                mult = e.num_experts if moe_mode == "dense" else \
                    e.experts_per_token * 1.25
                fb.moe += toks * (mult * exp_f + 2 * d * e.num_experts)
            elif cfg.d_ff > 0:
                fb.mlp += toks * mlp_f
        elif kind == BLOCK_RGLRU:
            w = cfg.lru_width or d
            fb.recurrent += toks * (2 * d * w * 3 + 4 * w * w
                                    + 2 * cfg.conv_kernel * w + 12 * w)
            fb.mlp += toks * mlp_f
        elif kind in (BLOCK_MLSTM, BLOCK_SLSTM):
            inner = int(d * cfg.proj_factor)
            if kind == BLOCK_MLSTM:
                h_ = cfg.num_heads
                hd_ = inner // h_
                cell = 6 * h_ * hd_ * hd_          # C update + n + Cq read
                fb.recurrent += toks * (4 * d * inner + 6 * inner * inner
                                        + 2 * cfg.conv_kernel * inner
                                        + cell + 2 * inner * d)
            else:
                h_ = cfg.num_heads
                hd_ = inner // h_
                fb.recurrent += toks * (2 * d * 4 * inner
                                        + 8 * h_ * hd_ * hd_ + 2 * inner * d)

    if cfg.is_encdec:
        # encoder self-attn + mlp over encoder frames
        ef = cfg.encoder_seq * B
        enc_p = _pad_to(cfg.encoder_seq, min(1024, cfg.encoder_seq))
        fb.encoder += cfg.encoder_layers * (
            ef * 2 * d * (nq * hd + 2 * nkv * hd + nq * hd)
            + B * enc_p * enc_p * nq * hd * 4
            + ef * mlp_f)
    if cfg.modality == "vision":
        from repro_torch.models.transformer import VISION_EMBED_DIM
        fb.frontend += B * cfg.frontend_tokens * 2 * (VISION_EMBED_DIM * d + d * d)
    if with_head:
        fb.head += toks * 2 * d * cfg.vocab_size
    return fb


def executed_flops(cfg: ModelConfig, shape: InputShape, *,
                   moe_mode: str = "dense", long_window=None) -> dict:
    B, S = shape.global_batch, shape.seq_len
    # vlm: layers process frontend+text = S tokens; the LM head only sees text
    if shape.kind == "train":
        fwd = forward_flops(cfg, B, S, S, moe_mode=moe_mode, with_head=False)
        S_text = S - (cfg.frontend_tokens if cfg.modality == "vision" else 0)
        fwd.head = B * S_text * 2 * cfg.d_model * cfg.vocab_size
        total = 4.0 * fwd.total   # fwd + remat recompute + 2x bwd
    elif shape.kind == "prefill":
        fwd = forward_flops(cfg, B, S, S, moe_mode=moe_mode,
                            with_head=False)
        total = fwd.total + B * 2 * cfg.d_model * cfg.vocab_size  # last-tok head
    else:   # decode: ONE token against a cache of S
        fwd = forward_flops(cfg, B, 1, S, moe_mode=moe_mode,
                            long_window=long_window)
        total = fwd.total
    return {"total": total, "breakdown": fwd.__dict__}


def executed_bytes(cfg: ModelConfig, shape: InputShape, *,
                   param_bytes: int = 2, moe_mode: str = "dense",
                   long_window=None) -> dict:
    """Coarse HBM-traffic model (global bytes):

    * params: train -> fwd read + recompute read + bwd read + write + adam
      m/v fp32 read+write = 8*P*pb + 16*P ; inference -> one read.
    * activations: residual+block r/w ~ 8 reads/writes of [toks, d] per layer.
    * kv cache / recurrent state: read (+write) once per step.
    * logits: chunked CE reads hidden + writes per-chunk logits once.
    """
    P = cfg.param_count()
    d = cfg.d_model
    B, S = shape.global_batch, shape.seq_len
    L = cfg.num_layers
    toks = B * (S if shape.kind != "decode" else 1)
    act = toks * d * param_bytes * 8 * L
    if shape.kind == "train":
        params = P * (4 * param_bytes + 16)
        logits = toks * cfg.vocab_size * 4 / 256 * 2   # one live chunk r/w
        cache = 0.0
    else:
        params = P * param_bytes
        logits = B * cfg.vocab_size * 4
        cache = 0.0
        for kind in cfg.layer_kinds:
            if kind in (ATTN_GLOBAL, ATTN_LOCAL):
                cap = S
                if kind == ATTN_LOCAL and cfg.sliding_window:
                    cap = min(S, cfg.sliding_window)
                if long_window is not None and kind == ATTN_GLOBAL:
                    cap = min(S, long_window)
                rw = 2 if shape.kind == "decode" else 1
                cache += B * cap * cfg.num_kv_heads * cfg.head_dim * 2 * param_bytes * rw
            elif kind == BLOCK_RGLRU:
                cache += B * (cfg.lru_width or d) * 4 * 2
            elif kind == BLOCK_MLSTM:
                inner = int(d * cfg.proj_factor)
                hd_ = inner // cfg.num_heads
                cache += B * cfg.num_heads * hd_ * hd_ * 4 * 2
            elif kind == BLOCK_SLSTM:
                cache += B * int(d * cfg.proj_factor) * 4 * 4 * 2
    total = params + act + cache + logits
    return {"total": total, "params": params, "activations": act,
            "cache": cache, "logits": logits}
