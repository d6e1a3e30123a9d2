"""Carry the JAX package's parameters into the port.

`from_jax_cnn_params(tree)` carries the GenFV CNN and
`from_jax_unet_params(tree)` the DDPM UNet (see their docstrings).

`from_jax_params(cfg, tree)` takes the JAX parameter pytree with numpy
leaves (`jax.tree.map(np.asarray, params)`) and returns the port's
parameter dict. Leaf map, JAX path -> port path:

    embed                       -> embed
    final_norm/scale            -> final_norm/scale
    groups[i]/<path>  (row g)   -> layers[g * len(pattern) + i]/<path>
    rem[j]/<path>               -> layers[G * len(pattern) + j]/<path>

where G = num_layers // len(pattern) is the number of stacked pattern
groups and <path> is the same below the layer (ln1, ln2, attn/wq, rec/w_a,
rec/conv/w, mlp/w_gate, ...). Dense weights keep their [d_in, d_out]
layout, because the port applies them as `x @ w` and stores no
`nn.Linear`; nothing is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.api import resolve_device
from repro_torch.tree import tree_map


def from_jax_params(cfg, tree, *, device="cuda"):
    """JAX parameter pytree (numpy leaves) -> port parameters on `device`,
    in the leaves' own dtypes."""
    tfm.check_supported(cfg)
    extra = set(tree) - {"embed", "final_norm", "groups", "rem"}
    if extra:
        raise ValueError(f"leaves the port does not carry: {sorted(extra)}")
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":          # ml_dtypes, unknown to torch
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        return t.to(device)

    plen = len(cfg.pattern)
    groups = tree.get("groups", [])
    G = cfg.num_layers // plen if groups else 0
    layers = [tree_map(lambda a, g=g: leaf(np.asarray(a)[g]), groups[i])
              for g in range(G) for i in range(plen)]
    layers += [tree_map(leaf, p) for p in tree["rem"]]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, {cfg.name} has "
                         f"{cfg.num_layers}")
    return {"embed": leaf(tree["embed"]),
            "final_norm": tree_map(leaf, tree["final_norm"]),
            "layers": layers}


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
