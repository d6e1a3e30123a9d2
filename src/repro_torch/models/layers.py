"""Shared building blocks on plain tensors (the counterpart of the JAX
package's `models/layers.py`).

Parameters are nested dicts of tensors in the JAX package's layout (dense
weights [d_in, d_out], applied as `x @ w`). Compute dtype follows the input.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def checkpointed(fn, *args):
    """fn(*args). Where a graph is being built, its activations are not
    kept for backward but recomputed there, as under the JAX package's
    `jax.checkpoint`; under no_grad or inference_mode it is a plain call."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def dense_init(gen, d_in: int, d_out: int, dtype, device, scale=None):
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen, vocab: int, d: int, dtype, device):
    w = torch.randn((vocab, d), generator=gen, device=device, dtype=torch.float32)
    return (w * (1.0 / d) ** 0.5).to(dtype)


def init_rmsnorm(d: int, dtype, device):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}  # gemma (1+scale)


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p["scale"].float())).to(dt)


def init_layernorm(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps: float = 1e-5):
    """Mean and (biased) variance in fp32, as the JAX package's two-pass
    `jnp.mean` / `jnp.var`."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * p["scale"].float() + p["bias"].float()).to(dt)


def init_norm(cfg, dtype, device, d=None):
    d = d if d is not None else cfg.d_model
    if cfg.norm == "layernorm":
        return init_layernorm(d, dtype, device)
    return init_rmsnorm(d, dtype, device)


def apply_norm(p, x):
    """layernorm where the parameters carry a bias, else rmsnorm."""
    return layernorm(p, x) if "bias" in p else rmsnorm(p, x)


def softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope(x, positions, theta: float = 10000.0):
    """x: [..., seq, heads, head_dim]; positions: [..., seq] int32."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].float() * freq             # [..., S, half]
    cos = torch.cos(angles)[..., :, None, :]                     # [..., S, 1, half]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen, cfg, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, d, f, dtype, device),
                "w_up": dense_init(gen, d, f, dtype, device),
                "w_down": dense_init(gen, f, d, dtype, device)}
    return {"w_up": dense_init(gen, d, f, dtype, device),
            "w_down": dense_init(gen, f, d, dtype, device)}


def mlp(p, x, mlp_type: str):
    if mlp_type in ("swiglu", "geglu"):
        gate = x @ p["w_gate"]
        act = F.silu(gate) if mlp_type == "swiglu" else F.gelu(gate, approximate="tanh")
        return (act * (x @ p["w_up"])) @ p["w_down"]
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


def init_conv1d(gen, width: int, kernel: int, dtype, device):
    w = torch.randn((kernel, width), generator=gen, device=device, dtype=torch.float32)
    return {"w": (w * (1.0 / kernel) ** 0.5).to(dtype),
            "b": torch.zeros((width,), dtype=dtype, device=device)}


def causal_conv1d(p, x, state=None):
    """Depthwise causal conv. x: [B, S, W]. state: [B, K-1, W] trailing inputs.
    Returns (y, new_state)."""
    k = p["w"].shape[0]
    if state is None:
        state = torch.zeros(x.shape[:-2] + (k - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xin = torch.cat([state, x], dim=-2)                          # [B, S+K-1, W]
    S = x.shape[-2]
    y = sum(xin[..., i:i + S, :] * p["w"][i] for i in range(k))
    y = y + p["b"]
    new_state = xin[..., -(k - 1):, :] if k > 1 else state
    return y.to(x.dtype), new_state
