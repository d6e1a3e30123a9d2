"""Class-conditional UNet noise predictor for 32x32 images (the DDPM
backbone, paper Sec. III-B / Sec. VI-A2), the counterpart of the JAX
package's `diffusion/unet.py`.

Topology: 32 -> 16 -> 8 resolution, [c, 2c, 4c] channels, residual blocks
with GroupNorm+SiLU, a self-attention block at 8x8, sinusoidal time
embedding + learned class embedding injected per block (FiLM-style shift).

Plain functions over a parameter tree with the JAX package's names and
structure; convolution weights are OIHW (the JAX package keeps HWIO),
activations NCHW, dense matrices [d_in, d_out] applied as `x @ W`
(`convert.from_jax_unet_params` maps one tree onto the other). The
stride-2 "SAME" padding and the GroupNorm group rule are the CNN's
(`models/cnn.py`); nearest resizing at exactly 2x is `F.interpolate`'s.
Every op is per image (GroupNorm normalizes each image alone, attention
attends within an image), so no op mixes batch rows.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.api import resolve_device
from repro_torch.models.cnn import conv2d as conv
from repro_torch.models.cnn import groupnorm


def time_embedding(t: torch.Tensor, dim: int, dtype=torch.float32) -> torch.Tensor:
    """Sinusoidal embedding of integer timesteps t [B] -> [B, dim], float32
    as in the JAX package: the frequencies are computed in `dtype` (the
    parameters'; the JAX package's under x64) and rounded to float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=dtype, device=t.device) / half)
    ang = t[:, None].float() * freqs.float()[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _res_apply(p, x, emb):
    h = conv(p["conv1"], F.silu(groupnorm(p["gn1"], x)))
    h = h + (emb @ p["emb"])[:, :, None, None]
    h = conv(p["conv2"], F.silu(groupnorm(p["gn2"], h)))
    if "proj" in p:
        x = conv(p["proj"], x)
    return x + h


def _attn_apply(p, x):
    B, C, H, W = x.shape
    h = groupnorm(p["gn"], x).reshape(B, C, H * W).transpose(1, 2)   # [B, HW, C]
    q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    a = torch.softmax(q @ k.transpose(1, 2) * (C ** -0.5), dim=-1)
    out = (a @ v) @ p["wo"]
    return x + out.transpose(1, 2).reshape(B, C, H, W)


def _up2(x):
    """Nearest resize to twice the height and width."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def unet_apply(p, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x: [B,3,32,32]; t: [B] int timesteps; y: [B] int classes. Returns
    eps_hat [B,3,32,32]."""
    emb = time_embedding(t, p["t_w1"].shape[0], x.dtype) + p["cls_emb"][y]
    emb = F.silu(emb @ p["t_w1"]) @ p["t_w2"]

    h0 = conv(p["in"], x)                       # 32, c1
    h1 = _res_apply(p["d1a"], h0, emb)          # 32, c1
    h2 = conv(p["down1"], h1, stride=2)         # 16, c2
    h2 = _res_apply(p["d2a"], h2, emb)          # 16, c2
    h3 = conv(p["down2"], h2, stride=2)         # 8,  c3
    h3 = _res_apply(p["mid1"], h3, emb)
    h3 = _attn_apply(p["mid_attn"], h3)
    h3 = _res_apply(p["mid2"], h3, emb)

    u = _res_apply(p["u2"], torch.cat([_up2(h3), h2], dim=1), emb)   # 16, c2
    u = _res_apply(p["u1"], torch.cat([_up2(u), h1], dim=1), emb)    # 32, c1
    return conv(p["out"], F.silu(groupnorm(p["out_gn"], u)))


def init_unet(rng: np.random.Generator, num_classes: int, base: int = 64,
              emb: int = 256, device="cuda") -> Dict[str, Any]:
    """Random parameters drawn on the host from `rng` with the JAX
    package's laws (He-normal convolutions, N(0, 1/d) dense layers, the
    residual blocks' second convolution and both output projections at
    1e-3, class embeddings at 0.02), then moved to `device`: the same rng
    state gives the same parameters on every device. Torch cannot draw JAX's
    threefry streams, so the values differ from `repro.diffusion.unet.
    init_unet`; `convert.from_jax_unet_params` carries those over."""
    device = resolve_device(device)

    def normal(shape, scale):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(device)

    def conv_w(k, c_in, c_out, scale=None):
        scale = (2.0 / (k * k * c_in)) ** 0.5 if scale is None else scale
        return normal((c_out, c_in, k, k), scale)

    def gn(c):
        return {"scale": torch.ones(c, device=device),
                "bias": torch.zeros(c, device=device)}

    def res(c_in, c_out):
        p = {"gn1": gn(c_in), "conv1": conv_w(3, c_in, c_out),
             "emb": normal((emb, c_out), (1.0 / emb) ** 0.5),
             "gn2": gn(c_out), "conv2": conv_w(3, c_out, c_out, scale=1e-3)}
        if c_in != c_out:
            p["proj"] = conv_w(1, c_in, c_out)
        return p

    def attn(c):
        s = (1.0 / c) ** 0.5
        return {"gn": gn(c), "wq": normal((c, c), s), "wk": normal((c, c), s),
                "wv": normal((c, c), s), "wo": normal((c, c), 1e-3)}

    c1, c2, c3 = base, base * 2, base * 4
    return {
        "cls_emb": normal((num_classes, emb), 0.02),
        "t_w1": normal((emb, emb), (1.0 / emb) ** 0.5),
        "t_w2": normal((emb, emb), (1.0 / emb) ** 0.5),
        "in": conv_w(3, 3, c1),
        "d1a": res(c1, c1),
        "down1": conv_w(3, c1, c2),      # stride 2: 32->16
        "d2a": res(c2, c2),
        "down2": conv_w(3, c2, c3),      # stride 2: 16->8
        "mid1": res(c3, c3),
        "mid_attn": attn(c3),
        "mid2": res(c3, c3),
        "u2": res(c3 + c2, c2),          # 16
        "u1": res(c2 + c1, c1),          # 32
        "out_gn": gn(c1),
        "out": conv_w(3, c1, 3, scale=1e-3),
    }
