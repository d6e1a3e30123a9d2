"""Attention with RoPE, sliding window, QKV bias, ring-buffer KV caches and
encoder-decoder cross attention (the counterpart of the JAX package's
`models/attention.py`). Two SDPA routes, picked by `impl`:

  * "kernel" -- `kernels.ops.flash_attention` (the hand-written CUDA
    kernel on the card, its plain version on the CPU); the default of
    prefill, decode and serving;
  * "torch" -- `sdpa_chunked`, the JAX package's `impl="jnp"` path: a
    chunked online softmax in plain differentiable torch ops, which
    training runs (the kernel has no backward, as the JAX package's
    Pallas kernel has none).

All masking is position-based: each cached slot stores its absolute token
position (-1 = empty), so causality, the window and ring-buffer wraparound
fall out of one comparison. Cache writes update the cache tensors in place
(the JAX package returns new arrays); the returned cache is the same dict.
"""
from __future__ import annotations

import torch

from typing import Optional

import torch.nn.functional as F

from repro_torch.configs.base import ATTN_LOCAL
from repro_torch.distributed import autoshard
from repro_torch.distributed.autoshard import aconstrain
from repro_torch.kernels import ops
from repro_torch.models.layers import checkpointed, dense_init, rope

NEG_INF = -2.0 ** 30  # large finite; avoids NaN from (-inf) - (-inf)
KV_CHUNK = 1024       # the kv block `attention` gives `sdpa_chunked`


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


def sdpa_chunked(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                 window: Optional[int] = None, attn_softcap=None,
                 kv_chunk: int = 1024, q_chunk: int = 512):
    """q: [B,Sq,nq,hd]; k, v: [B,Skv,nkv,hd]; q_pos: [B,Sq]; kv_pos: [B,Skv].

    Flash-style double blocking, as the JAX package's `sdpa_chunked`: an
    outer loop over q chunks, an inner loop over kv chunks, an online
    softmax in fp32. kv is padded to a chunk multiple with slots at
    position -1 (masked everywhere), q with rows at position -2^30 (the
    causal mask removes every slot, the normaliser is clamped). Where a
    graph is being built, each q block's kv sweep is recomputed in
    backward instead of keeping its accumulators. Returns [B,Sq,nq,hd] in
    q's dtype."""
    B, Sq, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = hd ** -0.5

    kv_chunk = min(kv_chunk, Skv)
    pad = (-Skv) % kv_chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    q_chunk = min(q_chunk, Sq)
    qpad = (-Sq) % q_chunk
    if qpad:
        q = F.pad(q, (0, 0, 0, 0, 0, qpad))
        q_pos = F.pad(q_pos, (0, qpad), value=-(2 ** 30))
    qg = (q * scale).reshape(B, Sq + qpad, nkv, g, hd)

    def q_block(q_i, qp_i):                                # [B,Qc,nkv,g,hd], [B,Qc]
        acc = torch.zeros((B, q_i.shape[1], nkv, g, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, nkv, g, q_i.shape[1]), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for j in range(0, Skv + pad, kv_chunk):
            k_j, v_j = k[:, j:j + kv_chunk], v[:, j:j + kv_chunk]
            p_j = kv_pos[:, j:j + kv_chunk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_i.float(), k_j.float())
            if attn_softcap is not None:
                s = attn_softcap * torch.tanh(s / attn_softcap)
            valid = p_j[:, None, None, None, :] >= 0
            if causal:
                rel = qp_i[:, None, None, :, None] - p_j[:, None, None, None, :]
                valid = valid & (rel >= 0)
                if window is not None:
                    valid = valid & (rel < window)
            s = torch.where(valid, s, NEG_INF)
            # amax splits the gradient between tied maxima, as jnp.max does
            m_i = torch.maximum(m, s.amax(-1))
            p_ = torch.exp(s - m_i[..., None])
            alpha = torch.exp(m - m_i)
            l = l * alpha + p_.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bqhgd", p_, v_j.float())
            acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
            m = m_i
        l = torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        return (acc / l).to(q.dtype)

    out = [checkpointed(q_block, qg[:, i:i + q_chunk], q_pos[:, i:i + q_chunk])
           for i in range(0, Sq + qpad, q_chunk)]
    return torch.cat(out, dim=1).reshape(B, Sq + qpad, nq, hd)[:, :Sq]


def _attend(q, k, v, q_pos, kv_pos, **kw):
    """`_sdpa`; under an active DeviceMesh on local shards: batch over the
    data axes and heads over 'model' where they divide, the layout the
    constraints pin on q, k and v. Where q's heads are split and the kv
    heads are not (GQA with fewer kv heads than the axis), each shard
    attends with the kv heads of its own q heads, as MHA."""
    heads = ("batch", None, "model", None)
    q_pl = autoshard.placements(q.shape, heads)
    kv_pl = autoshard.placements(k.shape, heads)
    if q_pl == autoshard.placements(q.shape, ("batch", None, None, None)):
        kv_pl = autoshard.placements(k.shape, ("batch", None, None, None))
    rows = ("batch", None)
    nq, nkv = q.shape[2], k.shape[2]

    def fn(q, k, v, qp, kp):
        if q.shape[2] < nq and k.shape[2] == nkv:
            n = q.shape[2]
            idx = (torch.arange(n, device=k.device) + autoshard.model_coordinate() * n) \
                // (nq // nkv)
            k, v = k[:, :, idx], v[:, :, idx]
        return _sdpa(q, k, v, qp, kp, **kw)

    return autoshard.local(fn, (q_pl, kv_pl, kv_pl, autoshard.placements(q_pos.shape, rows),
                                autoshard.placements(kv_pos.shape, rows)), (q_pl,))(
        q, k, v, q_pos, kv_pos)


def _sdpa(q, k, v, q_pos, kv_pos, *, causal, window, softcap, impl):
    if impl == "kernel":
        return ops.flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                   window=window, softcap=softcap)
    if impl == "torch":
        return sdpa_chunked(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                            attn_softcap=softcap, kv_chunk=KV_CHUNK)
    raise ValueError(f"unknown impl {impl!r}; 'kernel' or 'torch'")


def attention(p, x, cfg, kind: str, positions, cache=None, cross_kv=None,
              causal: bool = True, impl: str = "kernel"):
    """x: [B,S,d]; positions: [B,S] int32. Returns (y [B,S,d], cache).

    cross_kv: {"k", "v", "pos"} of the encoder frames for encoder-decoder
    cross attention: no cache update, non-causal over the frames, and q
    takes RoPE only under rmsnorm, as in the JAX package. `causal=False`
    is the encoder's self-attention. impl: "kernel" or "torch" (module
    docstring)."""
    B, S, _ = x.shape
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    if "bq" in p:
        q = autoshard.settle(q, ("batch", None, "model")) + p["bq"].to(q.dtype)
    q = aconstrain(autoshard.split_last(q, nq, hd), ("batch", None, "model", None))

    if cross_kv is not None:
        if cfg.norm == "rmsnorm":
            q = rope(q, positions, cfg.rope_theta)
        out = _attend(q, cross_kv["k"], cross_kv["v"], positions, cross_kv["pos"],
                      causal=False, window=None, softcap=cfg.attn_softcap, impl=impl)
        return autoshard.merge_last(out) @ p["wo"], cache

    k, v = x @ p["wk"], x @ p["wv"]
    if "bk" in p:
        k = autoshard.settle(k, ("batch", None, "model")) + p["bk"].to(k.dtype)
        v = autoshard.settle(v, ("batch", None, "model")) + p["bv"].to(v.dtype)
    k = aconstrain(autoshard.split_last(k, nkv, hd), ("batch", None, "model", None))
    v = aconstrain(autoshard.split_last(v, nkv, hd), ("batch", None, "model", None))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if kind == ATTN_LOCAL else None

    if cache is not None:
        write = _cache_write_decode if S == 1 else _cache_write_prefill
        autoshard.write_local(write, cache, k, v, positions)
        k_all, v_all, kv_pos = cache["k"], cache["v"], cache["pos"]
    else:
        k_all, v_all, kv_pos = k, v, positions

    out = _attend(q, k_all, v_all, positions, kv_pos, causal=causal, window=window,
                  softcap=cfg.attn_softcap, impl=impl)
    out = aconstrain(out, ("batch", None, "model", None))
    return autoshard.merge_last(out) @ p["wo"], cache
