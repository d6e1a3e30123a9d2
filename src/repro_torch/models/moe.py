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

from repro_torch.distributed import autoshard
from repro_torch.distributed.autoshard import aconstrain, logical_size
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
    xt = aconstrain(x.reshape(B * S, d), ("batch", None))
    combine, idx, aux = router_topk(p, xt, cfg)
    experts = {k: v for k, v in p.items() if k != "router"}
    if autoshard.sharded_mesh() is not None:
        return _moe_dense_sharded(experts, xt, combine, idx, cfg).reshape(B, S, d), aux
    w = _expert_weights(combine, idx, cfg.moe.num_experts)
    return _expert_sum(xt, w, experts, cfg.mlp_type).reshape(B, S, d), aux


def _expert_weights(combine, idx, num_experts: int):
    """[T, E]: each token's combine weight of each expert (0 where unrouted)."""
    return torch.zeros((combine.shape[0], num_experts), dtype=combine.dtype,
                       device=combine.device).scatter_add_(1, idx, combine)


def _expert_sum(xt, w, experts, mlp_type: str):
    """sum over experts e of ffn_e(xt) * w[:, e], in expert index order."""
    y = torch.zeros_like(xt)
    for i in range(w.shape[1]):
        p_e = {k: v[i] for k, v in experts.items()}
        y = y + _expert_ffn(p_e, xt, mlp_type) * w[:, i, None]
    return y


def _moe_dense_sharded(experts, xt, combine, idx, cfg):
    """The dense mode under an active DeviceMesh, on local shards: tokens
    over the data axes; experts over 'model' where E divides by it (each
    shard runs its own experts, the JAX rule's expert-parallel layout),
    else the expert FFN's hidden width over 'model' (each shard a slice of
    every expert). Each shard's sum is partial over 'model'."""
    E = cfg.moe.num_experts
    rows = autoshard.placements(xt.shape, ("batch", None))
    k_rows = autoshard.placements(idx.shape, ("batch", None))
    by_expert = E % logical_size("model") == 0
    w_pl = autoshard.placements((xt.shape[0], E), ("batch", "model" if by_expert else None))
    n = E // logical_size("model") if by_expert else E

    def own_weights(c, i):       # this shard's experts' columns
        return _expert_weights(c, i, E)[:, autoshard.model_coordinate() * n:][:, :n]

    w = autoshard.local(own_weights, (k_rows, k_rows), (w_pl,))(combine, idx)
    names = sorted(experts)
    leaf_pl = []
    for name in names:
        shape = experts[name].shape
        hidden = (None, None, "model") if name != "w_down" else (None, "model", None)
        leaf_pl.append(autoshard.placements(shape, ("model", None, None) if by_expert else hidden))

    def run(xt, w, *leaves):
        return _expert_sum(xt, w, dict(zip(names, leaves)), cfg.mlp_type)

    return autoshard.local(run, (rows, w_pl) + tuple(leaf_pl),
                           (autoshard.partial_over_model(rows),))(
        xt, w, *(experts[name] for name in names))


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
    sharded = autoshard.sharded_mesh() is not None
    if sharded:
        # DTensor regroups tokens only from whole rows (no sequence split)
        x = x.redistribute(x.device_mesh, autoshard.placements(x.shape, ("batch", None, None)))

    xt = x.reshape(T_all, d)
    if G > 1:
        xt = aconstrain(xt.reshape(G, Tg, d), ("batch", None, None)).reshape(T_all, d)
    combine, idx, aux = router_topk(p, xt, cfg)
    C = int(-(-Tg * k * capacity_factor // E))
    if sharded:
        xb, buf_w, buf_tok = _dispatch_sharded(xt, combine, idx, G, E, C)
    else:
        xb, buf_w, buf_tok = _dispatch(xt, combine, idx, G, E, C)

    # expert-parallel over "model", feature-parallel where E does not divide it
    exp_spec = ("batch", "model", None, None)
    if E % max(logical_size("model"), 1):
        exp_spec = ("batch", None, None, "model")
    xb = aconstrain(xb, exp_spec)
    up = torch.einsum("gecd,edf->gecf", xb, p["w_up"])
    if "w_gate" in p:
        hidden = _act(torch.einsum("gecd,edf->gecf", xb, p["w_gate"]), cfg.mlp_type) * up
    else:
        hidden = F.gelu(up, approximate="tanh")
    hidden = aconstrain(hidden, exp_spec)
    yb = aconstrain(torch.einsum("gecf,efd->gecd", hidden, p["w_down"]), exp_spec)
    if sharded:
        return _combine_sharded(yb, buf_w, buf_tok, Tg).reshape(B, S, d), aux
    return _combine(yb.reshape(G * E * C, d), buf_w, buf_tok, T_all).reshape(B, S, d), aux


def _dispatch(xt, combine, idx, G: int, E: int, C: int):
    """The sorted dispatch of T = xt.shape[0] tokens in G groups: (xb
    [G,E,C,d], buf_w [G*E*C], buf_tok [G*E*C], the token of each buffer
    row, T where the row is empty).

    One dispatch for all groups: group g's expert e is key g*E + e, so a
    stable sort by key orders each group's entries as its own sort would."""
    T, d = xt.shape
    k = idx.shape[-1]
    Tg = T // G
    dev = xt.device
    flat_tok = torch.arange(T, device=dev).repeat_interleave(k)      # [T*k]
    key = (flat_tok // Tg) * E + idx.reshape(-1)
    order = torch.argsort(key, stable=True)
    skey, stok, sw = key[order], flat_tok[order], combine.reshape(-1)[order]
    pos = torch.arange(T * k, device=dev) - torch.searchsorted(skey, skey, side="left")
    # a dropped entry goes to the spare last row, which is cut off
    dest = torch.where(pos < C, skey * C + pos, G * E * C)
    buf = torch.zeros((G * E * C + 1, d), dtype=xt.dtype, device=dev)
    buf[dest] = xt[stok]
    buf_w = torch.zeros((G * E * C + 1,), dtype=xt.dtype, device=dev)
    buf_w[dest] = sw
    buf_tok = torch.full((G * E * C + 1,), T, dtype=torch.long, device=dev)
    buf_tok[dest] = stok
    return buf[:-1].reshape(G, E, C, d), buf_w[:-1], buf_tok[:-1]


def _combine(yb, buf_w, buf_tok, T: int):
    """[T, d]: each token's sum of its buffer rows yb [G*E*C, d], weighted."""
    yb = yb * buf_w[:, None]
    return torch.zeros((T + 1, yb.shape[-1]), dtype=yb.dtype,
                       device=yb.device).index_add_(0, buf_tok, yb)[:-1]


def _dispatch_sharded(xt, combine, idx, G: int, E: int, C: int):
    """`_dispatch` under an active DeviceMesh, on local shards: each shard
    dispatches its own groups (the groups over the data axes where G
    divides by them, every group on every shard otherwise). Returns xb
    [G,E,C,d], buf_w and buf_tok [G, E*C] as DTensors, groups first."""
    T, d = xt.shape
    Tg = T // G
    grp = autoshard.placements((G, Tg, d), ("batch", None, None))

    def run(xt, combine, idx):
        g = xt.shape[0]
        xb, w, tok = _dispatch(xt.reshape(g * Tg, d), combine.reshape(g * Tg, -1),
                               idx.reshape(g * Tg, -1), g, E, C)
        return xb, w.reshape(g, E * C), tok.reshape(g, E * C)

    return autoshard.local(run, (grp, grp, grp), (grp, grp, grp))(
        xt.reshape(G, Tg, d), combine.reshape(G, Tg, -1), idx.reshape(G, Tg, -1))


def _combine_sharded(yb, buf_w, buf_tok, Tg: int):
    """`_combine` under an active DeviceMesh, on each shard's groups (the
    buffer's token indices are the shard's own): yb [G,E,C,d] -> [G, Tg, d]."""
    G, E, C, d = yb.shape
    grp = autoshard.placements(yb.shape, ("batch", None, None, None))

    def run(yb, w, tok):
        g = yb.shape[0]
        return _combine(yb.reshape(g * E * C, d), w.reshape(-1), tok.reshape(-1),
                        g * Tg).reshape(g, Tg, d)

    return autoshard.local(run, (grp, grp, grp), (grp,))(yb, buf_w, buf_tok)


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
