"""Attention with RoPE, sliding window, QKV bias, ring-buffer KV caches and
encoder-decoder cross attention (the counterpart of the JAX package's
`models/attention.py`), with SDPA through `kernels.ops.flash_attention`.

All masking is position-based: each cached slot stores its absolute token
position (-1 = empty), so causality, the window and ring-buffer wraparound
fall out of one comparison. Cache writes update the cache tensors in place
(the JAX package returns new arrays); the returned cache is the same dict.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN_LOCAL
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rope


def init_attention(gen, cfg, dtype, device):
    d, nq, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": dense_init(gen, d, nq * hd, dtype, device),
         "wk": dense_init(gen, d, nkv * hd, dtype, device),
         "wv": dense_init(gen, d, nkv * hd, dtype, device),
         "wo": dense_init(gen, nq * hd, d, dtype, device)}
    if cfg.qkv_bias:
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=device)
    return p


def init_kv_cache(cfg, kind: str, batch: int, max_len: int, dtype, device):
    cap = max_len
    if kind == ATTN_LOCAL and cfg.sliding_window:
        cap = min(max_len, cfg.sliding_window)
    shape = (batch, cap, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, cap), -1, dtype=torch.int32, device=device),
        # per-row write cursor: rows advance independently
        "idx": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _cache_write_decode(cache, k_new, v_new, positions):
    """Write one token (k_new: [B,1,nkv,hd]) at per-row slot idx % cap."""
    cap = cache["k"].shape[1]
    rows = torch.arange(cache["k"].shape[0], device=k_new.device)
    slot = (cache["idx"] % cap).long()
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][rows, slot] = positions[:, 0].to(torch.int32)
    cache["idx"] += 1
    return cache


def _cache_write_prefill(cache, k_full, v_full, positions):
    """Fill the cache with the (last cap tokens of the) prefill sequence.

    For S >= cap the last cap tokens land at slots 0..cap-1 and the cursor
    advances by S, exactly as in the JAX package: unless S % cap == 0, the
    next decode write (slot idx % cap) then overwrites a key that is still
    inside the window. The port keeps that arithmetic so that it serves the
    same tokens as the reference."""
    cap = cache["k"].shape[1]
    S = k_full.shape[1]
    if S >= cap:
        cache["k"].copy_(k_full[:, -cap:])
        cache["v"].copy_(v_full[:, -cap:])
        cache["pos"].copy_(positions[:, -cap:])
    else:
        cache["k"][:, :S] = k_full.to(cache["k"].dtype)
        cache["v"][:, :S] = v_full.to(cache["v"].dtype)
        cache["pos"][:, :S] = positions.to(torch.int32)
    cache["idx"] += S
    return cache


def attention(p, x, cfg, kind: str, positions, cache=None, cross_kv=None,
              causal: bool = True):
    """x: [B,S,d]; positions: [B,S] int32. Returns (y [B,S,d], cache).

    cross_kv: {"k", "v", "pos"} of the encoder frames for encoder-decoder
    cross attention: no cache update, non-causal over the frames, and q
    takes RoPE only under rmsnorm, as in the JAX package. `causal=False`
    is the encoder's self-attention."""
    B, S, _ = x.shape
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
    q = q.reshape(B, S, nq, hd)

    if cross_kv is not None:
        if cfg.norm == "rmsnorm":
            q = rope(q, positions, cfg.rope_theta)
        out = ops.flash_attention(q, cross_kv["k"], cross_kv["v"], positions,
                                  cross_kv["pos"], causal=False, window=None,
                                  softcap=cfg.attn_softcap)
        return out.reshape(B, S, nq * hd) @ p["wo"], cache

    k, v = x @ p["wk"], x @ p["wv"]
    if "bk" in p:
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, nkv, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, nkv, hd)
    window = cfg.sliding_window if kind == ATTN_LOCAL else None

    if cache is not None:
        write = _cache_write_decode if S == 1 else _cache_write_prefill
        write(cache, k, v, positions)
        k_all, v_all, kv_pos = cache["k"], cache["v"], cache["pos"]
    else:
        k_all, v_all, kv_pos = k, v, positions

    out = ops.flash_attention(q, k_all, v_all, positions, kv_pos, causal=causal,
                              window=window, softcap=cfg.attn_softcap)
    return out.reshape(B, S, nq * hd) @ p["wo"], cache
