"""Decoder-only backbone of the port (the counterpart of the JAX package's
`models/transformer.py`) for the attention and RG-LRU layer kinds.

The JAX package scans over pattern groups with parameters stacked per
group; here the layers are one list. Layer `g * len(pattern) + i` is group
`g`, position `i`, and the remainder layers follow, so the list order is
the JAX package's execution order (`convert.from_jax_params` unstacks
accordingly). Caches mirror the same list.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, BLOCK_MLSTM,
                                      BLOCK_RGLRU, BLOCK_SLSTM, ModelConfig)
from repro_torch.models.attention import (attention, init_attention,
                                          init_kv_cache)
from repro_torch.models.layers import (embed_init, init_mlp, init_rmsnorm, mlp,
                                       rmsnorm, softcap)
from repro_torch.models.rglru import init_rglru, init_rglru_state, rglru_block

_NEXT_FAMILIES = "ROADMAP.md Queue 1 item 11 (the remaining LM families)"


def check_supported(cfg: ModelConfig):
    """Raise NotImplementedError for what the port does not carry yet."""
    missing = []
    if cfg.moe is not None:
        missing.append("mixture-of-experts layers")
    if any(k in (BLOCK_MLSTM, BLOCK_SLSTM) for k in cfg.pattern):
        missing.append("xLSTM blocks")
    if cfg.is_encdec:
        missing.append("the encoder-decoder backbone")
    if cfg.modality == "vision":
        missing.append("the vision front end")
    if cfg.qkv_bias or cfg.norm != "rmsnorm" or not cfg.tie_embeddings:
        missing.append("qkv bias, layernorm and untied embeddings")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} are not ported yet; see {_NEXT_FAMILIES}")


def _init_layer(gen, cfg: ModelConfig, kind: str, dtype, device):
    p: Dict[str, Any] = {"ln1": init_rmsnorm(cfg.d_model, dtype, device)}
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        p["attn"] = init_attention(gen, cfg, dtype, device)
        if cfg.d_ff > 0:
            p["ln2"] = init_rmsnorm(cfg.d_model, dtype, device)
            p["mlp"] = init_mlp(gen, cfg, dtype, device)
    elif kind == BLOCK_RGLRU:
        p["rec"] = init_rglru(gen, cfg, dtype, device)
        p["ln2"] = init_rmsnorm(cfg.d_model, dtype, device)
        p["mlp"] = init_mlp(gen, cfg, dtype, device)
    else:
        raise ValueError(kind)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32):
    """Random parameters on `gen.device`, with the JAX package's shapes and
    scales (its random numbers are not reproduced)."""
    check_supported(cfg)
    device = gen.device
    return {
        "embed": embed_init(gen, cfg.padded_vocab_size, cfg.d_model, dtype, device),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
        "layers": [_init_layer(gen, cfg, kind, dtype, device)
                   for kind in cfg.layer_kinds],
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    """Decode cache: one dict per layer, batch first in every tensor."""
    check_supported(cfg)
    layers = []
    for kind in cfg.layer_kinds:
        if kind in (ATTN_GLOBAL, ATTN_LOCAL):
            layers.append({"kv": init_kv_cache(cfg, kind, batch, max_len, dtype, device)})
        else:
            layers.append({"rec": init_rglru_state(cfg, batch, dtype, device)})
    return {"layers": layers}


def _apply_layer(p, x, cfg, kind: str, positions, cache):
    """Returns (x, new_cache)."""
    new_cache = dict(cache) if cache is not None else None
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        h, kv = attention(p["attn"], rmsnorm(p["ln1"], x), cfg, kind, positions,
                          cache=None if cache is None else cache["kv"])
        if cache is not None:
            new_cache["kv"] = kv
        x = x + h
        if "mlp" in p:
            x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x), cfg.mlp_type)
    elif kind == BLOCK_RGLRU:
        h, rec = rglru_block(p["rec"], rmsnorm(p["ln1"], x), cfg,
                             state=None if cache is None else cache["rec"])
        if cache is not None:
            new_cache["rec"] = rec
        x = x + h
        x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x), cfg.mlp_type)
    else:
        raise ValueError(kind)
    return x, new_cache


def _embed_tokens(params, cfg, tokens):
    x = params["embed"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            cache=None, logits_mode: str = "full"):
    """Returns (logits_or_hidden, new_cache).

    batch keys: tokens [B,S]; optional positions [B,S] int32.
    logits_mode: "full" -> [B,S,V] fp32 logits; "hidden" -> final hidden."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).repeat(B, 1)
    new_layers = []
    for i, kind in enumerate(cfg.layer_kinds):
        x, c = _apply_layer(params["layers"][i], x, cfg, kind, positions,
                            None if cache is None else cache["layers"][i])
        new_layers.append(c)
    if cache is not None:
        cache = {"layers": new_layers}
    x = rmsnorm(params["final_norm"], x)
    if logits_mode == "hidden":
        return x, cache
    return unembed(params, cfg, x), cache


def unembed(params, cfg, x):
    logits = softcap((x @ params["embed"].T).float(), cfg.final_softcap)
    if cfg.padded_vocab_size != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab_size, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e9)
    return logits
