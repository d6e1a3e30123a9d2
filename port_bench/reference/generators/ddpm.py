"""The class-conditional DDPM of the program's `generator="ddpm"` path, in
plain PyTorch, float32: its UNet noise predictor at any base width and the
strided (eta=1) ancestral sampler over a subsequence of the noise
schedule, with each image's noise drawn as the program draws it.

The block gives base_width (c), embed_dim, timesteps, beta_min, beta_max,
num_classes and sampler_steps. The UNet: 32 -> 16 -> 8 resolution at c,
2c, 4c channels, a residual block (GroupNorm, SiLU, 3x3 convolution, the
embedding added as a shift, GroupNorm, SiLU, 3x3 convolution, a 1x1
projection where the width changes) at each level on the way down and up,
self-attention between two residual blocks at 8x8, a sinusoidal time
embedding plus a learned class embedding through two dense layers with
SiLU. Convolutions pad as XLA's "SAME" does; GroupNorm takes min(8, C)
groups (`reference/model.py`).

Sampling: image j of round r draws all its noise from one Philox stream
keyed SeedSequence((run seed, r, 0x41494743), spawn_key=(j,)): a block of
sampler_steps + 1 standard normals of shape [32, 32, 3], row i the noise
of denoising position i, the last row x_T. The schedule's betas are a
linear ramp, its alpha-bars their cumulative product, both in float64; the
step coefficients are float64 numbers applied to float32 tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.generators import flat, unflat
from port_bench.reference.model import FP32, Precision, conv2d, gnorm

#: the domain tag of the sampling streams ("AIGC")
GEN_KEY = 0x41494743
IMG = 32
#: images sampled together
BLOCK = 256
#: the planted faults of the check's readings: one denoising step left
#: out, each label moved to the next class, each image on the next image's
#: noise
FAULTS = ("skip_step", "shift_labels", "other_noise")


def widths(block: dict) -> tuple[int, int, int]:
    c = int(block["base_width"])
    return c, 2 * c, 4 * c


def param_shapes(block: dict) -> dict:
    """The UNet's parameter tree: convolutions OIHW, dense layers
    [d_in, d_out], GroupNorm scale and bias."""
    e = int(block["embed_dim"])
    c1, c2, c3 = widths(block)

    def gn(c):
        return {"scale": (c,), "bias": (c,)}

    def res(c_in, c_out):
        p = {"gn1": gn(c_in), "conv1": (c_out, c_in, 3, 3), "emb": (e, c_out),
             "gn2": gn(c_out), "conv2": (c_out, c_out, 3, 3)}
        if c_in != c_out:
            p["proj"] = (c_out, c_in, 1, 1)
        return p

    return {"cls_emb": (int(block["num_classes"]), e), "t_w1": (e, e), "t_w2": (e, e),
            "in": (c1, 3, 3, 3), "d1a": res(c1, c1), "down1": (c2, c1, 3, 3),
            "d2a": res(c2, c2), "down2": (c3, c2, 3, 3), "mid1": res(c3, c3),
            "mid_attn": {"gn": gn(c3), "wq": (c3, c3), "wk": (c3, c3), "wv": (c3, c3),
                         "wo": (c3, c3)},
            "mid2": res(c3, c3), "u2": res(c3 + c2, c2), "u1": res(c2 + c1, c1),
            "out_gn": gn(c1), "out": (3, c1, 3, 3)}


def make_params(block: dict, seed: int, device) -> dict:
    """Weights from `seed`, drawn on `device` in one call, at scales that
    keep each layer's output near unit variance, as a trained network's
    are: He-normal convolutions (std sqrt(2 / fan_in)), dense layers
    N(0, 1 / d_in), class embeddings N(0, 1), GroupNorm scale 1 and bias
    0. (The program's own initial law puts each block's second convolution
    and the output projections at 1e-3, which leaves a fresh network
    nearly blind to its labels and its steps.)"""
    shapes = flat(param_shapes(block))
    drawn = {k: s for k, s in shapes.items() if len(s) > 1}
    sizes = [math.prod(s) for s in drawn.values()]
    gen = torch.Generator(device=device).manual_seed((int(seed) ^ GEN_KEY) % 2 ** 63)
    noise = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (k, s), x in zip(drawn.items(), torch.split(noise, sizes)):
        if k == "cls_emb":
            std = 1.0
        elif len(s) == 4:
            std = (2.0 / (s[1] * s[2] * s[3])) ** 0.5
        else:
            std = (1.0 / s[0]) ** 0.5
        out[k] = x.view(s) * std
    for k, s in shapes.items():
        if len(s) == 1:
            fill = 1.0 if k.endswith("scale") else 0.0
            out[k] = torch.full(s, fill, device=device)
    return unflat(out)


# -- the UNet -----------------------------------------------------------------
def _mm(a, b, prec: Precision):
    a, b = prec.operands(a, b)
    return a @ b


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of integer timesteps [B] -> [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t[:, None].float() * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _res(p, x, emb, prec):
    h = conv2d(p["conv1"], F.silu(gnorm(p["gn1"], x)), 1, prec)
    h = h + _mm(emb, p["emb"], prec)[:, :, None, None]
    h = conv2d(p["conv2"], F.silu(gnorm(p["gn2"], h)), 1, prec)
    if "proj" in p:
        x = conv2d(p["proj"], x, 1, prec)
    return x + h


def _attn(p, x, prec):
    B, C, H, W = x.shape
    h = gnorm(p["gn"], x).reshape(B, C, H * W).transpose(1, 2)
    q, k, v = (_mm(h, p[w], prec) for w in ("wq", "wk", "wv"))
    a = torch.softmax(_mm(q, k.transpose(1, 2), prec) * C ** -0.5, dim=-1)
    out = _mm(_mm(a, v, prec), p["wo"], prec)
    return x + out.transpose(1, 2).reshape(B, C, H, W)


def _up2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def unet(p, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
         prec: Precision = FP32) -> torch.Tensor:
    """x [B, 3, 32, 32], t [B] timesteps, y [B] classes -> the predicted
    noise [B, 3, 32, 32]."""
    emb = time_embedding(t, p["t_w1"].shape[0]) + p["cls_emb"][y]
    emb = _mm(F.silu(_mm(emb, p["t_w1"], prec)), p["t_w2"], prec)
    h0 = conv2d(p["in"], x, 1, prec)
    h1 = _res(p["d1a"], h0, emb, prec)
    h2 = _res(p["d2a"], conv2d(p["down1"], h1, 2, prec), emb, prec)
    h3 = _res(p["mid1"], conv2d(p["down2"], h2, 2, prec), emb, prec)
    h3 = _res(p["mid2"], _attn(p["mid_attn"], h3, prec), emb, prec)
    u = _res(p["u2"], torch.cat([_up2(h3), h2], dim=1), emb, prec)
    u = _res(p["u1"], torch.cat([_up2(u), h1], dim=1), emb, prec)
    return conv2d(p["out"], F.silu(gnorm(p["out_gn"], u)), 1, prec)


# -- sampling -----------------------------------------------------------------
def alpha_bars(block: dict) -> np.ndarray:
    betas = np.linspace(block["beta_min"], block["beta_max"], block["timesteps"])
    return np.cumprod(1.0 - betas)


def strided(timesteps: int, steps: int) -> np.ndarray:
    """`steps` timesteps of [0, timesteps), both ends included, ascending."""
    if steps == 1:
        return np.array([timesteps - 1])
    return np.round(np.linspace(0.0, timesteps - 1, steps)).astype(np.int64)


def noise(run_seed: int, round_idx: int, first: int, n: int, steps: int) -> np.ndarray:
    """[n, steps + 1, 32, 32, 3] float32: the noise of images first ..
    first + n - 1 of the round."""
    out = np.empty((n, steps + 1, IMG, IMG, 3), np.float32)
    entropy = (int(run_seed), int(round_idx), GEN_KEY)
    for j in range(n):
        ss = np.random.SeedSequence(entropy, spawn_key=(first + j,))
        out[j] = np.random.Generator(np.random.Philox(ss)).standard_normal(
            out.shape[1:], dtype=np.float32)
    return out


@torch.no_grad()
def sample(block: dict, params, y: torch.Tensor, z: torch.Tensor,
           prec: Precision = FP32, skip: int | None = None) -> torch.Tensor:
    """Strided ancestral sampling: y [B] classes, z [steps + 1, B, 3, 32, 32]
    noise by position -> x_0 [B, 3, 32, 32] clipped to [-1, 1]. `skip` is
    a position whose denoising step is left out (a planted fault)."""
    steps = int(block["sampler_steps"])
    abar = alpha_bars(block)
    ts = strided(int(block["timesteps"]), steps)
    x = z[steps]
    for i in reversed(range(steps)):
        if i == skip:
            continue
        a_t = abar[ts[i]]
        a_prev = abar[ts[i - 1]] if i > 0 else 1.0
        eps = unet(params, x, torch.full_like(y, int(ts[i])), y, prec)
        x0 = (x - math.sqrt(1.0 - a_t) * eps) / math.sqrt(a_t)
        var = (1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev)
        sigma = math.sqrt(max(var, 0.0))
        x = math.sqrt(a_prev) * x0 + math.sqrt(max(1.0 - a_prev - sigma ** 2, 0.0)) * eps
        if i > 0:
            x = x + sigma * z[i]
    return x.clamp(-1.0, 1.0)


def generate(block, params, labels, rng, run_seed, round_idx, device, *,
             prec: Precision = FP32, fault: str | None = None) -> np.ndarray:
    """The round's images for `labels`, image j on noise stream j; `rng`
    is not drawn from."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"no planted fault {fault!r}; faults: {FAULTS}")
    labels = np.asarray(labels, np.int64)
    n, steps = len(labels), int(block["sampler_steps"])
    out = np.empty((n, IMG, IMG, 3), np.float32)
    if fault == "shift_labels":
        labels = (labels + 1) % int(block["num_classes"])
    shift = 1 if fault == "other_noise" else 0
    skip = steps // 2 if fault == "skip_step" else None
    with prec.active(device):
        for a in range(0, n, BLOCK):
            b = min(a + BLOCK, n)
            z = torch.from_numpy(noise(run_seed, round_idx, a + shift, b - a, steps))
            z = z.to(device).permute(1, 0, 4, 2, 3)
            y = torch.from_numpy(labels[a:b]).to(device)
            x = sample(block, params, y, z, prec, skip)
            out[a:b] = x.permute(0, 2, 3, 1).cpu().numpy()
    return out


# -- work ---------------------------------------------------------------------
def step_flops(block: dict) -> float:
    """FLOPs of one image's UNet forward pass (one denoising step):
    2 c_in c_out k^2 a convolution's output pixel, 2 d_in d_out a dense
    layer, attention's projections and its two [HW, HW] products at 8x8.
    GroupNorm, SiLU, softmax and the sums are left out, as
    torch.utils.flop_counter leaves them out."""
    e = int(block["embed_dim"])
    c1, c2, c3 = widths(block)

    def conv(c_in, c_out, k, size):
        return 2.0 * c_in * c_out * k * k * size * size

    def res(c_in, c_out, size):
        f = conv(c_in, c_out, 3, size) + conv(c_out, c_out, 3, size) + 2.0 * e * c_out
        return f + (conv(c_in, c_out, 1, size) if c_in != c_out else 0.0)

    hw = 8 * 8
    attn = 4 * 2.0 * hw * c3 * c3 + 2 * 2.0 * hw * hw * c3
    return (2 * 2.0 * e * e + conv(3, c1, 3, IMG) + res(c1, c1, IMG) + conv(c1, c2, 3, 16)
            + res(c2, c2, 16) + conv(c2, c3, 3, 8) + 2 * res(c3, c3, 8) + attn
            + res(c3 + c2, c2, 16) + res(c2 + c1, c1, IMG) + conv(c1, 3, 3, IMG))
