"""SUBP4 — data-generation amount (paper Sec. V-B4, eq. 12-13, 47-48).

The RSU generates images while vehicles train; the optimal count fills the
straggler window:
    b* = floor( (max_n (T_cp + T_mu) - T_s^cp(b_prev)) / t0 )        (eq. 48)
with t0 = sum_t d_m,t / f_rsu the per-image diffusion inference latency
(eq. 12) and T_s^cp the augmented-model training time (eq. 13).

Generated labels are spread uniformly (IID target distribution, Sec. V-B4).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import GenFVConfig
from repro_torch.core.gpu_model import GpuModelConsts, CONSTS, rsu_train_time


@dataclass(frozen=True)
class DiffusionService:
    steps: int = 50                 # I inference steps per image
    d_cycles: float = 1.2e7         # cycles per step (d_m,t)
    f_rsu: float = 12.0e9           # RSU inference capacity (Hz)

    @property
    def t_per_image(self) -> float:
        """t0 in eq. (12)."""
        return self.steps * self.d_cycles / self.f_rsu


def inference_time(svc: DiffusionService, b: int) -> float:
    """Eq. (12): T_inf = b * t0."""
    return b * svc.t_per_image


def optimal_generation(t_bar: float, b_prev: int, svc: DiffusionService,
                       batch_size: int = 64,
                       gpu: GpuModelConsts = CONSTS) -> int:
    """Eq. (48). t_bar = max_n(T_cp + T_mu) of the selected vehicles."""
    t_train_prev = rsu_train_time(max(b_prev // batch_size, 1), gpu)
    budget = t_bar - t_train_prev
    if budget <= 0:
        return 0
    return int(np.floor(budget / svc.t_per_image))


def label_schedule(b: int, num_classes: int) -> np.ndarray:
    """Uniform per-label counts for b images (IID target, Sec. V-B4)."""
    base = b // num_classes
    extra = b % num_classes
    out = np.full(num_classes, base, np.int64)
    out[:extra] += 1
    return out
