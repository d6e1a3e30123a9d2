"""Bucketed batched DDPM sampling with per-image noise streams, the
counterpart of the JAX package's `gen/sampler.py`.

Image ``j`` of a schedule is a pure function of (params, round key,
``start + j``, label):

* **per-image streams** — image ``g`` (its global index in the round's
  schedule) draws all its noise from one host Philox generator seeded by
  ``SeedSequence(round key entropy, spawn_key=(g,))``: a block of
  ``sampler_steps + 1`` standard normals of shape [32, 32, 3], row ``i``
  the step noise of denoising position ``i`` and row ``sampler_steps`` the
  initial x_T (the JAX package's position tags, whose draws are threefry
  `fold_in` streams torch cannot reproduce). Drawing on the host makes the
  noise the same on every device. The UNet is per image, so no op mixes
  batch rows.
* **bucketing** — schedules pad to the power-of-two bucket family of
  `core/planner.py::bucket_size` (floor 4, shared with the fleet engine);
  padded slots run label 0 on zero noise and are sliced off.
* **strided schedule** — ``sampler_steps`` subsamples the full
  ``ddpm.timesteps`` noise schedule DDIM-style (eta=1: the ancestral
  posterior over the subsequence of alpha-bars), the quality/cost dial SUBP4
  prices generation against.

The denoising loop is a Python loop of ``sampler_steps`` UNet calls; the
step coefficients are float32 (float64) host scalars computed as the JAX
package computes them on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.planner import bucket_size
from repro_torch.diffusion.ddpm import DDPM
from repro_torch.diffusion.unet import unet_apply

IMAGE_SHAPE = (32, 32, 3)


def strided_timesteps(timesteps: int, sampler_steps: int) -> np.ndarray:
    """Ascending subsequence of ``sampler_steps`` timesteps out of
    ``[0, timesteps)``, endpoints included (the DDIM stride)."""
    if not 1 <= sampler_steps <= timesteps:
        raise ValueError(f"sampler_steps={sampler_steps} outside "
                         f"[1, {timesteps}]")
    if sampler_steps == 1:
        ts = np.array([timesteps - 1])
    else:
        ts = np.round(np.linspace(0.0, timesteps - 1, sampler_steps))
    ts = ts.astype(np.int64)
    if len(np.unique(ts)) != len(ts):   # linspace step >= 1: cannot happen
        raise ValueError("strided schedule collapsed to duplicate timesteps")
    return ts


def image_noise(key: np.random.SeedSequence, start: int, n: int,
                sampler_steps: int) -> np.ndarray:
    """The noise of images start .. start+n-1 of the round keyed `key`:
    [n, sampler_steps + 1, 32, 32, 3] float32 (see the module docstring)."""
    out = np.empty((n, sampler_steps + 1) + IMAGE_SHAPE, np.float32)
    for j in range(n):
        ss = np.random.SeedSequence(key.entropy,
                                    spawn_key=tuple(key.spawn_key) + (start + j,))
        np.random.Generator(np.random.Philox(ss)).standard_normal(
            out.shape[1:], dtype=np.float32, out=out[j])
    return out


def _sample_strided(params, ddpm: DDPM, y: torch.Tensor, sampler_steps: int,
                    noise: torch.Tensor) -> torch.Tensor:
    """Strided (eta=1) ancestral sampling. y [B] labels; noise
    [sampler_steps + 1, B, 3, 32, 32] by position tag. Returns x_0 [B, 3, 32,
    32], clipped to [-1, 1], in the parameters' dtype."""
    dt = np.float64 if noise.dtype == torch.float64 else np.float32
    one = dt(1)
    ts = strided_timesteps(ddpm.timesteps, sampler_steps)
    abars = ddpm.alpha_bars(dt)
    B = y.shape[0]
    x = noise[sampler_steps]
    for s in range(sampler_steps):
        i = sampler_steps - 1 - s            # descending position in ts
        t = int(ts[i])
        abar_t = abars[t]
        abar_prev = abars[ts[i - 1]] if i > 0 else one
        tb = torch.full((B,), t, dtype=torch.int64, device=y.device)
        eps_hat = unet_apply(params, x, tb, y)
        x0_hat = (x - float(np.sqrt(one - abar_t)) * eps_hat) / float(np.sqrt(abar_t))
        # eta=1 posterior variance over the strided subsequence; at the
        # full stride this is the eq. (1) ancestral posterior
        var = (one - abar_prev) / (one - abar_t) * (one - abar_t / abar_prev)
        sigma = np.sqrt(np.maximum(var, dt(0)))
        dir_x = np.sqrt(np.maximum(one - abar_prev - sigma ** 2, dt(0)))
        mean = float(np.sqrt(abar_prev)) * x0_hat + float(dir_x) * eps_hat
        x = mean + float(sigma) * noise[i] if i > 0 else mean
    return torch.clamp(x, -1.0, 1.0)


@torch.no_grad()
def sample_schedule(params, ddpm: DDPM, key: np.random.SeedSequence, labels,
                    sampler_steps: int, start: int = 0,
                    bucket: int | None = None,
                    noise: np.ndarray | None = None) -> np.ndarray:
    """Sample one (possibly multi-vehicle, multi-label) schedule in one
    bucketed pass on the parameters' device: labels [n] -> images [n, 32,
    32, 3] float32 on the host. Image ``j`` is a pure function of (params,
    key, start + j, labels[j]), so callers slicing a schedule into
    per-label or per-vehicle calls with matching ``start`` offsets
    reproduce it (bitwise on the CPU; tests/test_torch_genfv_gen.py).

    `noise` [n, sampler_steps + 1, 32, 32, 3] replaces the draws of
    `image_noise(key, start, n, sampler_steps)` (tests inject the JAX
    package's); `bucket` overrides the power-of-two padding."""
    labels = np.asarray(labels, np.int64)
    n = len(labels)
    if n == 0:
        return np.empty((0,) + IMAGE_SHAPE, np.float32)
    kb = bucket_size(n) if bucket is None else int(bucket)
    if kb < n:
        raise ValueError(f"bucket {kb} smaller than schedule {n}")
    if noise is None:
        noise = image_noise(key, start, n, sampler_steps)
    want = (n, sampler_steps + 1) + IMAGE_SHAPE
    if noise.shape != want:
        raise ValueError(f"noise block {noise.shape} != {want}")
    leaf = params["in"]
    y = torch.zeros(kb, dtype=torch.int64)
    y[:n] = torch.from_numpy(labels)
    z = torch.zeros((sampler_steps + 1, kb, 3, 32, 32), dtype=leaf.dtype,
                    device=leaf.device)
    # host [n, tag, H, W, C] -> device [tag, n, C, H, W]
    z[:, :n] = torch.from_numpy(np.ascontiguousarray(noise)).to(
        leaf.device).permute(1, 0, 4, 2, 3)
    x = _sample_strided(params, ddpm, y.to(leaf.device), int(sampler_steps), z)
    # the copy to the host waits for the device
    return x[:n].permute(0, 2, 3, 1).float().cpu().numpy()
