"""Mixture-of-Experts layer (grok-1: 8 experts top-2, olmoe: 64 experts
top-8), the counterpart of the JAX package's `models/moe.py`.

Two compute modes:

* ``dense``  — every expert runs on every token and the outputs are
  combined with the router weights, accumulated in expert index order (the
  reference's `lax.scan` over experts). Exact and simple; E/k times the
  routed FLOPs.
* ``sorted`` — tokens are replicated k times, stably sorted by expert id,
  and each expert processes a fixed-capacity contiguous block
  (C = ceil(T*k*cf/E)). Tokens past their expert's capacity are dropped
  from it (they keep the residual path), underflow is padded. ``n_groups``
  splits the token stream into independent dispatch groups.

Router: softmax over the expert logits, top-k, renormalised combine
weights, and the load-balancing auxiliary loss E * sum_e f_e * P_e.
The expert products are plain matrix products (the JAX package runs them
outside any Pallas kernel).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_moe(gen, cfg, dtype, device):
    e = cfg.moe
    d, f = cfg.d_model, e.d_expert

    def stack(d_in, d_out):
        return torch.stack([dense_init(gen, d_in, d_out, dtype, device)
                            for _ in range(e.num_experts)])

    p = {"router": dense_init(gen, d, e.num_experts, dtype, device),
         "w_up": stack(d, f),
         "w_down": stack(f, d)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = stack(d, f)
    return p


def _act(gate, mlp_type: str):
    return F.silu(gate) if mlp_type == "swiglu" else F.gelu(gate, approximate="tanh")


def _expert_ffn(p_e, x, mlp_type: str):
    """x: [..., d]; p_e: one expert's parameters (expert dim removed)."""
    if "w_gate" in p_e:
        return (_act(x @ p_e["w_gate"], mlp_type) * (x @ p_e["w_up"])) @ p_e["w_down"]
    return F.gelu(x @ p_e["w_up"], approximate="tanh") @ p_e["w_down"]


def router_topk(p, x, cfg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (combine [T,k] in x's dtype, expert_idx [T,k] int64, aux
    loss scalar fp32). x: [T, d] flattened tokens.

    `torch.topk` and `jax.lax.top_k` may order tied probabilities
    differently; the two agree wherever the top-k margins are nonzero."""
    e = cfg.moe
    logits = (x @ p["router"]).float()                         # [T, E]
    probs = torch.softmax(logits, dim=-1)
    combine, idx = torch.topk(probs, e.experts_per_token, dim=-1)
    combine = combine / torch.clamp(combine.sum(-1, keepdim=True), min=1e-9)
    T = x.shape[0]
    onehot = F.one_hot(idx, e.num_experts).float()              # [T, k, E]
    f_e = onehot.sum((0, 1)) / (T * e.experts_per_token)
    aux = e.num_experts * torch.sum(f_e * probs.mean(0))
    return combine.to(x.dtype), idx, aux


def moe_dense(p, x, cfg):
    """Dense mode. x: [B, S, d] -> (y, aux_loss)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    combine, idx, aux = router_topk(p, xt, cfg)
    w = torch.zeros((xt.shape[0], cfg.moe.num_experts), dtype=x.dtype,
                    device=x.device).scatter_add_(1, idx, combine)   # [T, E]
    experts = {k: v for k, v in p.items() if k != "router"}
    y = torch.zeros_like(xt)
    for i in range(cfg.moe.num_experts):                # expert index order
        p_e = {k: v[i] for k, v in experts.items()}
        y = y + _expert_ffn(p_e, xt, cfg.mlp_type) * w[:, i, None]
    return y.reshape(B, S, d), aux


def moe_sorted(p, x, cfg, capacity_factor: float = 1.25, n_groups: int = 1):
    """Sort-based mode: FLOPs about k/E of dense mode (+ capacity slack).
    x: [B, S, d] -> (y, aux_loss)."""
    B, S, d = x.shape
    e = cfg.moe
    k, E = e.experts_per_token, e.num_experts
    T_all = B * S
    if T_all % n_groups:
        n_groups = 1
    G = n_groups
    Tg = T_all // G
    dev = x.device

    xt = x.reshape(T_all, d)
    combine, idx, aux = router_topk(p, xt, cfg)
    C = int(-(-Tg * k * capacity_factor // E))

    # One dispatch for all groups: group g's expert e is key g*E + e, so a
    # stable sort by key orders each group's entries as its own sort would.
    flat_tok = torch.arange(T_all, device=dev).repeat_interleave(k)      # [T_all*k]
    key = (flat_tok // Tg) * E + idx.reshape(-1)
    order = torch.argsort(key, stable=True)
    skey, stok, sw = key[order], flat_tok[order], combine.reshape(-1)[order]
    pos = torch.arange(T_all * k, device=dev) - torch.searchsorted(skey, skey, side="left")
    # a dropped entry goes to the spare last row, which is cut off
    dest = torch.where(pos < C, skey * C + pos, G * E * C)
    buf = torch.zeros((G * E * C + 1, d), dtype=x.dtype, device=dev)
    buf[dest] = xt[stok]
    buf_w = torch.zeros((G * E * C + 1,), dtype=x.dtype, device=dev)
    buf_w[dest] = sw
    buf_tok = torch.full((G * E * C + 1,), T_all, dtype=torch.long, device=dev)
    buf_tok[dest] = stok
    xb = buf[:-1].reshape(G, E, C, d)

    # The reference lays the dispatch buffer out expert-parallel over its
    # "model" mesh axis (feature-parallel where E does not divide it). On
    # one card that axis has size 1, every E divides it, and the first,
    # expert-parallel spec is the one taken; it is a layout hint with no
    # effect on the values, so nothing here stands for it.
    up = torch.einsum("gecd,edf->gecf", xb, p["w_up"])
    if "w_gate" in p:
        hidden = _act(torch.einsum("gecd,edf->gecf", xb, p["w_gate"]), cfg.mlp_type) * up
    else:
        hidden = F.gelu(up, approximate="tanh")
    yb = torch.einsum("gecf,efd->gecd", hidden, p["w_down"])
    yb = yb.reshape(G * E * C, d) * buf_w[:-1, None]
    y = torch.zeros((T_all + 1, d), dtype=x.dtype, device=dev).index_add_(0, buf_tok[:-1], yb)[:-1]
    return y.reshape(B, S, d), aux


def sorted_groups(T: int) -> int:
    """The `sorted_grouped` group count: the largest of 64, 32, ..., 2 that
    divides T and leaves at least 2048 tokens a group, else 1."""
    for g in (64, 32, 16, 8, 4, 2):
        if T % g == 0 and T // g >= 2048:
            return g
    return 1


def moe(p, x, cfg, mode: str = "dense"):
    if mode == "sorted":
        return moe_sorted(p, x, cfg)
    if mode == "sorted_grouped":
        return moe_sorted(p, x, cfg, n_groups=sorted_groups(x.shape[0] * x.shape[1]))
    return moe_dense(p, x, cfg)
