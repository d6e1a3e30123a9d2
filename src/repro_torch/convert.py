"""Carry the JAX package's parameters into the port.

`from_jax_cnn_params(tree)` carries the GenFV CNN and
`from_jax_unet_params(tree)` the DDPM UNet (see their docstrings).

`from_jax_params(cfg, tree)` takes the JAX parameter pytree with numpy
leaves (`jax.tree.map(np.asarray, params)`) and returns the port's
parameter dict. Leaf map (`jax_leaf_map`), JAX path -> port path:

    embed                       -> embed
    final_norm/<scale, bias>    -> final_norm/<scale, bias>
    lm_head                     -> lm_head            (untied embeddings)
    frontend_proj/<w1, w2>      -> frontend_proj/<w1, w2>   (llava)
    groups[i]/<path>  (row g)   -> layers[g * len(pattern) + i]/<path>
    rem[j]/<path>               -> layers[G * len(pattern) + j]/<path>
    encoder/groups[0]/<path> (row l) -> encoder/layers[l]/<path>  (whisper)
    encoder/final_norm/<...>    -> encoder/final_norm/<...>

where G = num_layers // len(pattern) is the number of stacked pattern
groups and <path> is the same below the layer (ln1, ln2, lnx, attn/wq,
attn/bq, cross/wk, rec/w_a, rec/conv/w, mlp/w_gate, moe/router,
moe/w_up, cell/wq, cell/b_if, cell/r, ...). xlstm-1.3b has 6 groups of
8 and no remainder. Dense weights keep their [d_in, d_out] layout,
because the port applies them as `x @ w` and stores no `nn.Linear`; MoE
stacks keep the expert dimension leading ([E, d, f]), the sLSTM's
recurrent `cell/r` its [4, h, hd, hd]. Nothing is transposed.
Any other top-level leaf raises.

`cell_state_from_jax` / `cell_state_to_jax` carry one xLSTM layer's decode
state between the JAX package's tuple and the port's dict (the order is
`MLSTM_STATE` or `SLSTM_STATE`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import BLOCK_MLSTM
from repro_torch.models.api import resolve_device
from repro_torch.tree import tree_map

_TOP = {"embed", "final_norm", "lm_head", "frontend_proj", "groups", "rem", "encoder"}
MLSTM_STATE = ("C", "n", "m", "conv")
SLSTM_STATE = ("c", "n", "m", "h")


def _row(a, g):
    return np.asarray(a)[g]


def jax_leaf_map(cfg, tree, row=_row):
    """The port's parameter tree with each leaf the JAX leaf it is carried
    from, unconverted; `row(a, g)` takes row g of a leaf stacked over
    pattern groups (or encoder layers)."""
    extra = set(tree) - _TOP
    if extra:
        raise ValueError(f"leaves the port does not carry: {sorted(extra)}")

    def unstack(groups, n_rows):
        return [tree_map(lambda a, g=g: row(a, g), grp)
                for g in range(n_rows) for grp in groups]

    plen = len(cfg.pattern)
    groups = tree.get("groups", [])
    layers = unstack(groups, cfg.num_layers // plen if groups else 0) + list(tree["rem"])
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, {cfg.name} has "
                         f"{cfg.num_layers}")
    out = {k: tree[k] for k in ("embed", "final_norm", "lm_head", "frontend_proj")
           if k in tree}
    out["layers"] = layers
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {"layers": unstack(enc["groups"], cfg.encoder_layers),
                          "final_norm": enc["final_norm"]}
    return out


def from_jax_params(cfg, tree, *, device="cuda"):
    """JAX parameter pytree (numpy leaves) -> port parameters on `device`,
    in the leaves' own dtypes."""
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":          # ml_dtypes, unknown to torch
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        return t.to(device)

    return tree_map(leaf, jax_leaf_map(cfg, tree))


def _state_names(kind):
    return MLSTM_STATE if kind == BLOCK_MLSTM else SLSTM_STATE


def cell_state_from_jax(kind, state, *, device="cuda"):
    """An mLSTM or sLSTM layer's JAX decode state (a tuple of arrays) ->
    the port's dict on `device`."""
    device = resolve_device(device)
    return {name: torch.from_numpy(np.array(a)).to(device)
            for name, a in zip(_state_names(kind), state)}


def cell_state_to_jax(kind, state):
    """The port's mLSTM or sLSTM state dict -> the JAX package's tuple of
    numpy arrays."""
    return tuple(state[name].detach().cpu().numpy() for name in _state_names(kind))


def from_jax_cnn_params(tree, *, device="cuda"):
    """JAX GenFV CNN parameter pytree (numpy leaves,
    `jax.tree.map(np.asarray, params)` of `repro.models.cnn.init_cnn`) ->
    the port's tree of the same names on `device` (`models/cnn.py`).
    Convolution weights go from HWIO to OIHW; GroupNorm scale and bias and
    the head's `w` [C, classes] and `b` keep their layout."""
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a, np.float32)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.array(a, order="C")).to(device)

    return tree_map(leaf, tree)


def from_jax_unet_params(tree, *, device="cuda"):
    """JAX DDPM UNet parameter pytree (numpy leaves of
    `repro.diffusion.unet.init_unet`) -> the port's tree of the same names on
    `device` (`diffusion/unet.py`), by the CNN's leaf rule: convolutions go
    from HWIO to OIHW; dense matrices keep their [d_in, d_out] (`x @ W`)
    layout, and GroupNorm scale and bias theirs."""
    return from_jax_cnn_params(tree, device=device)
