"""DDPM (paper Sec. III-B, eq. 1-2): forward noising, noise-prediction loss
and ancestral sampling, class-conditional; the counterpart of the JAX
package's `diffusion/ddpm.py`.

q(x_t | x_{t-1}) = N(sqrt(1-lambda_t) x_{t-1}, lambda_t I)          (eq. 1)
L = E || eps - eps_theta(x_t, t) ||^2                               (eq. 2)

The noise schedule is computed on the host in numpy, op for op as the JAX
package's `jnp.cumprod(1 - jnp.linspace(...))` is written, with the
cumulative product in the order XLA on the CPU multiplies. XLA's float32
division is not IEEE's, so a beta can differ from the reference's by one
ulp (as the reference's own jitted and eager values do): `alpha_bars`
equals the reference bit for bit at 8 timesteps and in float64 at 200, and
lies within one ulp of it in float32 at 200 (tests/test_torch_genfv_gen.py).
Torch cannot draw JAX's threefry streams: `ddpm_loss` takes its t and eps
draws as arguments and `ddpm_sample` draws from a numpy Generator the caller
passes (or takes the whole noise block).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.diffusion.unet import init_unet, unet_apply

#: XLA on the CPU rewrites a cumulative product into a scan over blocks of
#: this many elements (prefix products inside each block, the block totals
#: scanned the same way, each block's prefixes scaled by the product of the
#: blocks before it); `_xla_cumprod` multiplies in that order.
XLA_SCAN_BLOCK = 16


def _linspace(start: float, stop: float, num: int, dtype) -> np.ndarray:
    """`jnp.linspace(start, stop, num)` in `dtype`, op for op."""
    start, stop = dtype(start), dtype(stop)
    if num == 1:
        return np.array([start], dtype)
    div = num - 1
    step = np.arange(div, dtype=dtype) / dtype(div)
    out = start * (dtype(1) - step) + stop * step
    return np.concatenate([out, np.array([stop], dtype)])


def _xla_cumprod(x: np.ndarray) -> np.ndarray:
    n, B = len(x), XLA_SCAN_BLOCK
    blocks = [np.cumprod(x[i:i + B], dtype=x.dtype) for i in range(0, n, B)]
    if len(blocks) == 1:
        return blocks[0]
    before = _xla_cumprod(np.array([b[-1] for b in blocks], x.dtype))
    return np.concatenate([blocks[0]] + [before[j - 1] * blocks[j]
                                         for j in range(1, len(blocks))])


@dataclass(frozen=True)
class DDPM:
    timesteps: int = 200
    beta_min: float = 1e-4
    beta_max: float = 0.02
    num_classes: int = 10
    base_width: int = 32

    def betas(self, dtype=np.float32) -> np.ndarray:
        return _linspace(self.beta_min, self.beta_max, self.timesteps, dtype)

    def alpha_bars(self, dtype=np.float32) -> np.ndarray:
        return _xla_cumprod(dtype(1) - self.betas(dtype))


def make_ddpm(rng: np.random.Generator, ddpm: DDPM, device="cuda"):
    return init_unet(rng, ddpm.num_classes, base=ddpm.base_width, device=device)


def _np_dtype(x: torch.Tensor):
    return np.float64 if x.dtype == torch.float64 else np.float32


def q_sample(ddpm: DDPM, x0, t, eps):
    """Eq. (1) composed over t steps: x_t = sqrt(abar_t) x0 + sqrt(1-abar_t) eps."""
    abars = torch.from_numpy(ddpm.alpha_bars(_np_dtype(x0))).to(x0.device)
    abar = abars[t][:, None, None, None]
    return torch.sqrt(abar) * x0 + torch.sqrt(1.0 - abar) * eps


def ddpm_loss(params, ddpm: DDPM, x0, y, t, eps):
    """Eq. (2) on images x0 [B,3,32,32] with labels y, at the timesteps t
    [B] and the noise eps [B,3,32,32] the caller drew."""
    x_t = q_sample(ddpm, x0, t, eps)
    eps_hat = unet_apply(params, x_t, t, y)
    return torch.mean(torch.square(eps - eps_hat))


def draw_loss_noise(rng: np.random.Generator, ddpm: DDPM, batch: int):
    """One step's (t [B] int64, eps [B,32,32,3] float32) for `ddpm_loss`,
    drawn on the host (t first), so every device sees the same draws."""
    t = rng.integers(0, ddpm.timesteps, batch)
    return t, rng.standard_normal((batch, 32, 32, 3), dtype=np.float32)


@torch.no_grad()
def ddpm_sample(params, ddpm: DDPM, labels, rng: np.random.Generator | None = None,
                noise: np.ndarray | None = None) -> np.ndarray:
    """Ancestral sampling over all `ddpm.timesteps`: labels [B] int ->
    images [B,32,32,3] in [-1,1] (numpy float32). The noise block
    [timesteps + 1, B, 32, 32, 3] holds x_T first, then each step's draw in
    sampling order; without `noise` it is drawn from `rng` in that order.
    One chain for the whole batch: an image's noise depends on the batch
    it rides in (gen/sampler.py keys each image instead)."""
    leaf = params["in"]
    dt = _np_dtype(leaf)
    T = ddpm.timesteps
    B = len(labels)
    if noise is None:
        noise = rng.standard_normal((T + 1, B, 32, 32, 3), dtype=np.float32)
    if noise.shape != (T + 1, B, 32, 32, 3):
        raise ValueError(f"noise block {noise.shape} != {(T + 1, B, 32, 32, 3)}")
    z = torch.from_numpy(np.ascontiguousarray(noise)).to(leaf.device)
    z = z.permute(0, 1, 4, 2, 3).to(leaf.dtype)
    betas = ddpm.betas(dt)
    alphas = dt(1) - betas
    abars = ddpm.alpha_bars(dt)
    y = torch.as_tensor(np.asarray(labels, np.int64), device=leaf.device)
    x = z[0]
    for i in range(T):
        t = T - 1 - i
        tb = torch.full((B,), t, dtype=torch.int64, device=leaf.device)
        eps_hat = unet_apply(params, x, tb, y)
        coef = betas[t] / np.sqrt(dt(1) - abars[t])
        mean = (x - float(coef) * eps_hat) / float(np.sqrt(alphas[t]))
        x = mean + float(np.sqrt(betas[t])) * z[1 + i] if t > 0 else mean
    return torch.clamp(x, -1.0, 1.0).permute(0, 2, 3, 1).float().cpu().numpy()
