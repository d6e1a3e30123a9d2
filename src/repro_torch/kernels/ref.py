"""Plain PyTorch versions of the two kernels (O(Sq x Skv) attention, a
sequential scan). The wrappers take them for CPU tensors; on the card they
are what each kernel is held to.

Fully-masked query rows: a row with no valid kv slot returns the uniform
average of V over the Skv real slots. That is what the Pallas kernel (for
Skv <= 128 or Skv % 128 == 0) and `sdpa_chunked` of the JAX package return;
the JAX `kernels/ref.py` returns zeros there instead.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG = -1e30


def flash_attention_ref(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """q: [B,Sq,nq,hd]; k,v: [B,Skv,nkv,hd]; positions int32 (-1 = empty).

    Returns [B,Sq,nq,hd] in q.dtype. fp32 softmax."""
    B, Sq, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    qg = q.reshape(B, Sq, nkv, g, hd).float() * (hd ** -0.5)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    valid = (kv_pos >= 0)[:, None, None, None, :]
    if causal:
        rel = q_pos[:, None, None, :, None] - kv_pos[:, None, None, None, :]
        valid = valid & (rel >= 0)
        if window is not None:
            valid = valid & (rel < window)
    # masked scores are a large finite value, so a row with no valid slot
    # softmaxes to the uniform distribution over the real slots
    s = torch.where(valid, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, nq, hd).to(q.dtype)


def rglru_scan_ref(log_a, b, h0=None):
    """h_t = exp(log_a_t) h_{t-1} + b_t along dim 1 for [B,S,W] fp32, from
    h0 ([B,W] fp32), or from zeros when h0 is None."""
    a = torch.exp(log_a)
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0.clone()
    out = torch.empty_like(b)
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
