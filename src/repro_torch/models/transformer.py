"""Decoder-only, encoder-decoder and VLM backbones of the port (the
counterpart of the JAX package's `models/transformer.py`) for every layer
kind: attention, MoE, RG-LRU, mLSTM and sLSTM; and the training loss.

The JAX package scans over pattern groups with parameters stacked per
group; here the layers are one list. Layer `g * len(pattern) + i` is group
`g`, position `i`, and the remainder layers follow, so the list order is
the JAX package's execution order (`convert.from_jax_params` unstacks
accordingly). Caches mirror the same list. The whisper encoder's layers
are a second list under `params["encoder"]`.

`impl` picks the attention and scan route: "kernel" (the default of
prefill, decode and serving) goes through `kernels.ops`; "torch" is the
counterpart of the JAX package's `impl="jnp"`, plain differentiable torch
ops (`attention.sdpa_chunked`, `rglru.lru_scan`), which training runs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, BLOCK_MLSTM,
                                      BLOCK_RGLRU, BLOCK_SLSTM, ModelConfig)
from repro_torch.distributed import autoshard
from repro_torch.distributed.autoshard import aconstrain
from repro_torch.models import xlstm as xl
from repro_torch.models.attention import (attention, init_attention,
                                          init_kv_cache)
from repro_torch.models.layers import (apply_norm, checkpointed, dense_init,
                                       embed_init, init_mlp, init_norm, mlp, softcap)
from repro_torch.models.moe import init_moe, moe
from repro_torch.models.rglru import init_rglru, init_rglru_state, rglru_block

VISION_EMBED_DIM = 1024      # CLIP-ViT-L patch embedding width (llava stub)
XENT_CHUNK = 256


# module-level MoE compute mode ("dense" is the reference's default)
_MOE_MODE = {"mode": "dense"}


def set_moe_mode(mode: str):
    if mode not in ("dense", "sorted", "sorted_grouped"):
        raise ValueError(f"unknown MoE mode {mode!r}")
    _MOE_MODE["mode"] = mode


def get_moe_mode() -> str:
    return _MOE_MODE["mode"]


def _init_layer(gen, cfg: ModelConfig, kind: str, dtype, device, cross: bool):
    p: Dict[str, Any] = {"ln1": init_norm(cfg, dtype, device)}
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        p["attn"] = init_attention(gen, cfg, dtype, device)
        if cross:
            p["lnx"] = init_norm(cfg, dtype, device)
            p["cross"] = init_attention(gen, cfg, dtype, device)
        if cfg.moe is not None:
            p["ln2"] = init_norm(cfg, dtype, device)
            p["moe"] = init_moe(gen, cfg, dtype, device)
        elif cfg.d_ff > 0:
            p["ln2"] = init_norm(cfg, dtype, device)
            p["mlp"] = init_mlp(gen, cfg, dtype, device)
    elif kind == BLOCK_RGLRU:
        p["rec"] = init_rglru(gen, cfg, dtype, device)
        p["ln2"] = init_norm(cfg, dtype, device)
        p["mlp"] = init_mlp(gen, cfg, dtype, device)
    elif kind == BLOCK_MLSTM:
        p["cell"] = xl.init_mlstm(gen, cfg, dtype, device)
    elif kind == BLOCK_SLSTM:
        p["cell"] = xl.init_slstm(gen, cfg, dtype, device)
    else:
        raise ValueError(kind)
    return p


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, num_layers=cfg.encoder_layers, pattern=(ATTN_GLOBAL,))


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                dtype=torch.float32, device=None):
    """Random parameters with the JAX package's shapes and scales (its
    random numbers are not reproduced), on `device` (default: `gen.device`;
    `gen=None` with the meta device builds the shapes alone)."""
    device = gen.device if device is None else torch.device(device)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.padded_vocab_size, d, dtype, device),
        "final_norm": init_norm(cfg, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.padded_vocab_size, dtype, device)
    if cfg.modality == "vision":
        # llava projector: 2-layer MLP from the CLIP width to d_model
        params["frontend_proj"] = {"w1": dense_init(gen, VISION_EMBED_DIM, d, dtype, device),
                                   "w2": dense_init(gen, d, d, dtype, device)}
    params["layers"] = [_init_layer(gen, cfg, kind, dtype, device, cfg.is_encdec)
                        for kind in cfg.layer_kinds]
    if cfg.is_encdec:
        enc_cfg = _encoder_cfg(cfg)
        params["encoder"] = {
            "layers": [_init_layer(gen, enc_cfg, ATTN_GLOBAL, dtype, device, False)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": init_norm(cfg, dtype, device)}
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    """Decode cache: one dict per layer, batch first in every tensor. An
    encoder-decoder layer also holds `cross_kv` (zeros at position 0 over
    `encoder_seq` frames, as in the JAX package, until the caller attaches
    the encoder's K/V with `attach_cross_kv`). Recurrent layers hold their
    state: {"rec": ...} for RG-LRU, {"cell": ...} for mLSTM and sLSTM."""
    layers = []
    for kind in cfg.layer_kinds:
        if kind in (ATTN_GLOBAL, ATTN_LOCAL):
            c = {"kv": init_kv_cache(cfg, kind, batch, max_len, dtype, device)}
            if cfg.is_encdec:
                shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
                c["cross_kv"] = {
                    "k": torch.zeros(shape, dtype=dtype, device=device),
                    "v": torch.zeros(shape, dtype=dtype, device=device),
                    "pos": torch.zeros((batch, cfg.encoder_seq), dtype=torch.int32,
                                       device=device)}
            layers.append(c)
        elif kind == BLOCK_RGLRU:
            layers.append({"rec": init_rglru_state(cfg, batch, dtype, device)})
        elif kind == BLOCK_MLSTM:
            layers.append({"cell": xl.init_mlstm_state(cfg, batch, dtype, device)})
        else:
            layers.append({"cell": xl.init_slstm_state(cfg, batch, dtype, device)})
    return {"layers": layers}


def _apply_layer(p, x, cfg, kind: str, positions, cache, *, cross_kv=None,
                 long_window: Optional[int] = None, impl: str = "kernel"):
    """Returns (x, new_cache, aux_loss). cross_kv: the layer's encoder K/V
    {"k", "v", "pos"}, which an encoder-decoder layer requires."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = dict(cache) if cache is not None else None
    # under an active DeviceMesh the residual's sequence split (between the
    # scanned groups) is gathered, as the JAX program gathers it for the
    # layer's projections (DTensor before torch 2.13 cannot flatten a split
    # sequence into a matmul's rows, nor its gradient), and a pending sum
    # is reduced into rows
    x = autoshard.settle(autoshard.gather_seq(x), ("batch", None, None))
    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        # long-context serving variant (gemma2): global layers take the
        # sliding window, so long decode stays sub-quadratic
        eff_kind = ATTN_LOCAL if long_window is not None and kind == ATTN_GLOBAL else kind
        h, kv = attention(p["attn"], apply_norm(p["ln1"], x), cfg, eff_kind, positions,
                          cache=None if cache is None else cache["kv"], impl=impl)
        if cache is not None:
            new_cache["kv"] = kv
        x = x + h
        if "cross" in p:
            h, _ = attention(p["cross"], apply_norm(p["lnx"], x), cfg, ATTN_GLOBAL,
                             positions, cross_kv=cross_kv, impl=impl)
            x = x + h
        if "moe" in p:
            h, aux_l = moe(p["moe"], apply_norm(p["ln2"], x), cfg, mode=_MOE_MODE["mode"])
            aux = aux + cfg.moe.router_aux_loss * aux_l
            x = x + h
        elif "mlp" in p:
            x = x + mlp(p["mlp"], apply_norm(p["ln2"], x), cfg.mlp_type)
    elif kind == BLOCK_RGLRU:
        h, rec = rglru_block(p["rec"], apply_norm(p["ln1"], x), cfg,
                             state=None if cache is None else cache["rec"], impl=impl)
        if cache is not None:
            new_cache["rec"] = rec
        x = x + h
        x = x + mlp(p["mlp"], apply_norm(p["ln2"], x), cfg.mlp_type)
    elif kind in (BLOCK_MLSTM, BLOCK_SLSTM):
        # pre-norm residual blocks: the block's own projections replace the MLP
        block = xl.mlstm_block if kind == BLOCK_MLSTM else xl.slstm_block
        h, st = block(p["cell"], apply_norm(p["ln1"], x), cfg,
                      state=None if cache is None else cache["cell"])
        if cache is not None:
            new_cache["cell"] = st
        x = x + h
    else:
        raise ValueError(kind)
    return x, new_cache, aux


def _embed_tokens(params, cfg, tokens):
    x = _lookup(params["embed"], tokens)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _lookup(table, tokens):
    """table[tokens]. Under an active DeviceMesh on local shards, as the
    JAX program partitions a gather from a vocab-split table: each shard
    looks up the tokens of its own vocab rows (zeros for the others), a
    partial sum over 'model'; the rows over the data axes."""
    V = table.shape[0]
    t_pl = autoshard.placements(table.shape, ("model", None))
    ids = autoshard.placements(tokens.shape, ("batch", None))
    out = autoshard.placements(tuple(tokens.shape) + (table.shape[1],), ("batch", None, None))
    if any(p.is_shard(0) for p in t_pl or ()):
        out = autoshard.partial_over_model(out)

    def own_rows(t, i):
        n = t.shape[0]
        if n == V:
            return t[i]
        i = i.long() - autoshard.model_coordinate() * n
        ok = (i >= 0) & (i < n)
        return t[i.clamp(0, n - 1)] * ok[..., None].to(t.dtype)

    return autoshard.local(own_rows, (t_pl, ids), (out,))(table, tokens)


def _arange_rows(B: int, n: int, device):
    return torch.arange(n, dtype=torch.int32, device=device).repeat(B, 1)


def encode(params, cfg, frames, *, impl: str = "kernel"):
    """Whisper encoder over (stubbed) frame embeddings [B, F, d]:
    non-causal self-attention and the MLP per layer, then the final norm."""
    enc = params["encoder"]
    x = frames
    pos = _arange_rows(x.shape[0], x.shape[1], x.device)
    for p in enc["layers"]:
        h, _ = attention(p["attn"], apply_norm(p["ln1"], x), cfg, ATTN_GLOBAL, pos,
                         causal=False, impl=impl)
        x = x + h
        x = x + mlp(p["mlp"], apply_norm(p["ln2"], x), cfg.mlp_type)
    return apply_norm(enc["final_norm"], x)


def build_cross_kv(params, cfg, enc_out):
    """Project the encoder output into each decoder layer's cross K/V
    (no bias, as in the JAX package): a list with one {"k", "v", "pos"}
    per decoder layer."""
    B, F_, _ = enc_out.shape
    pos = _arange_rows(B, F_, enc_out.device)
    shape = (B, F_, cfg.num_kv_heads, cfg.head_dim)
    return [{"k": (enc_out @ p["cross"]["wk"]).reshape(shape),
             "v": (enc_out @ p["cross"]["wv"]).reshape(shape), "pos": pos}
            for p in params["layers"]]


def attach_cross_kv(cache, cross_kv):
    """Put each decoder layer's cross K/V into the decode cache (the caller
    does this before prefill, as the JAX package's tests do). Returns the
    cache."""
    for c, ckv in zip(cache["layers"], cross_kv):
        c["cross_kv"] = ckv
    return cache


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            cache=None, impl: str = "kernel", remat: bool = False,
            long_window: Optional[int] = None, logits_mode: str = "full"):
    """Returns (logits_or_hidden, new_cache, aux).

    batch keys: tokens [B,S]; optional positions [B,S] int32; vision:
    patch_embeds [B,P,1024], prepended after the projector, with the token
    positions shifted by P; audio: frames [B,F,d], encoded here when no
    cache is given (with a cache, the caller attaches the cross K/V).
    impl: "kernel" or "torch" (module docstring); remat: recompute each
    layer in backward (where a graph is being built) instead of keeping
    its activations.
    logits_mode: "full" -> [B,S,V] fp32 logits; "hidden" -> final hidden."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = aconstrain(_embed_tokens(params, cfg, tokens), ("batch", None, None))

    n_front = 0
    if cfg.modality == "vision" and "patch_embeds" in batch:
        fp = params["frontend_proj"]
        pe = F.gelu(batch["patch_embeds"] @ fp["w1"], approximate="tanh") @ fp["w2"]
        x = torch.cat([pe.to(x.dtype), x], dim=1)
        n_front = pe.shape[1]
        S = S + n_front

    positions = batch.get("positions")
    if positions is None:
        positions = _arange_rows(B, S, x.device)
    elif n_front:
        positions = torch.cat([_arange_rows(B, n_front, x.device), positions + n_front], dim=1)

    cross = [None] * cfg.num_layers
    if cfg.is_encdec and cache is None:
        # training path: encode, and attend over the sequence itself. The
        # JAX package writes the sequence into a fresh S-slot cache and
        # attends over that, which is the same; without the cache nothing
        # is written in place under autograd.
        cross = build_cross_kv(params, cfg, encode(params, cfg, batch["frames"], impl=impl))
    elif cfg.is_encdec:
        cross = [c["cross_kv"] for c in cache["layers"]]

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_layers = []
    plen = len(cfg.pattern)
    grouped = (cfg.num_layers // plen) * plen
    for i, kind in enumerate(cfg.layer_kinds):
        # the residual between the JAX package's scanned groups is
        # sequence-parallel (Megatron-SP): batch over the data axes, the
        # sequence over 'model'
        if i < grouped and i % plen == 0:
            x = aconstrain(x, ("batch", "model", None))
        layer = functools.partial(_apply_layer, params["layers"][i], cfg=cfg, kind=kind,
                                  positions=positions,
                                  cache=None if cache is None else cache["layers"][i],
                                  cross_kv=cross[i], long_window=long_window, impl=impl)
        x, c, a = checkpointed(layer, x) if remat else layer(x)
        if i < grouped and i % plen == plen - 1:
            x = aconstrain(x, ("batch", "model", None))
        new_layers.append(c)
        aux = aux + a
    if cache is not None:
        cache = {"layers": new_layers}
    x = apply_norm(params["final_norm"], autoshard.gather_seq(x))
    if n_front:
        x = x[:, n_front:]
    if logits_mode == "hidden":
        return x, cache, aux
    return unembed(params, cfg, x), cache, aux


def unembed(params, cfg, x):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = softcap((x @ w).float(), cfg.final_softcap)
    if cfg.padded_vocab_size != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab_size, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e9)
    return logits


# ---------------------------------------------------------------------------
# Loss: chunked-vocab cross entropy, never all [B,S,V] logits at once
# ---------------------------------------------------------------------------
def _xent_chunk(params, cfg, h, t, m):
    logits = aconstrain(unembed(params, cfg, h), ("batch", None, "model"))  # [B,chunk,V] fp32
    if autoshard.sharded_mesh() is not None:
        lse, ll = _sharded_lse_and_pick(logits, t)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, t.long()[..., None])[..., 0]
    return ((lse - ll) * m).sum(), m.sum()


def _sharded_lse_and_pick(logits, t):
    """(logsumexp over the vocab, the target's logit) of DTensor logits
    [B,chunk,V] whose vocab may be split over 'model', as the JAX program
    partitions logsumexp and take_along_axis: each shard's max, sum of
    exponentials and masked pick of the target, left as partial results
    (max, sum, sum) that DTensor reduces across the shards."""
    from torch.distributed.tensor import Partial
    pl = logits.placements
    rows = autoshard.placements(t.shape, ("batch", None))

    def partial(op):
        return tuple(Partial(op) if p.is_shard(2) else p for p in pl)

    def shard_max(l):
        return l.detach().amax(-1)

    def shard_sumexp(l, mx):
        return torch.exp(l - mx[..., None]).sum(-1)

    def shard_pick(l, t):
        n = l.shape[-1]
        tl = t.long() - autoshard.model_coordinate() * n if n < logits.shape[-1] else t.long()
        ok = (tl >= 0) & (tl < n)
        g = torch.gather(l, -1, tl.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(ok, g, torch.zeros_like(g))

    mx = autoshard.local(shard_max, (pl,), (partial("max"),))(logits).redistribute(
        logits.device_mesh, rows)
    se = autoshard.local(shard_sumexp, (pl, rows), (partial("sum"),))(logits, mx)
    lse = torch.log(se.redistribute(logits.device_mesh, rows)) + mx
    ll = autoshard.local(shard_pick, (pl, rows), (partial("sum"),))(logits, t)
    return lse, ll.redistribute(logits.device_mesh, rows)


def chunked_xent(params, cfg, hidden, targets, mask, chunk: int = XENT_CHUNK):
    """hidden: [B,S,d]; targets, mask: [B,S]. Mean masked cross entropy in
    fp32 over sequence chunks, summed in order; where a graph is being
    built each chunk's logits are recomputed in backward instead of kept
    (at vocab 152k one [8,256,V] chunk is 1.2 GB)."""
    S = hidden.shape[1]
    chunk = min(chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    mask = mask.float()
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        l, c = checkpointed(_xent_chunk, params, cfg, hidden[:, sl], targets[:, sl],
                            mask[:, sl])
        tot, cnt = tot + l, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, cfg, batch, *, impl: str = "torch", remat: bool = False):
    """(ce + aux, {"ce", "aux"}) of a batch with "targets" [B,S] and an
    optional "mask" [B,S] (default all ones)."""
    hidden, _, aux = forward(params, cfg, batch, impl=impl, remat=remat,
                             logits_mode="hidden")
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(batch["targets"], dtype=torch.float32)
    ce = chunked_xent(params, cfg, hidden, batch["targets"], mask)
    return ce + aux, {"ce": ce, "aux": aux}
