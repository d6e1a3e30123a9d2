"""GPU execution-time and power models (paper Sec. IV-A3, eq. 6-8).

T_cp = t0 + c1 b theta_mem / f_mem + c2 b theta_core / f_core
p_cp = p_G0 + zeta_mem f_mem + zeta_core V_core^2 f_core
E_cp = p_cp * T_cp
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.mobility import Vehicle


@dataclass(frozen=True)
class GpuModelConsts:
    t0: float = 0.01            # task-independent launch overhead (s)
    c1: float = 1.0             # data-fetch cycle scale
    c2: float = 1.0             # compute cycle scale
    theta_mem: float = 2.0e7    # mem cycles per mini-batch
    theta_core: float = 8.0e7   # core cycles per mini-batch
    p_g0: float = 5.0           # static power (W)
    zeta_mem: float = 2.0e-9    # W per memory Hz
    zeta_core: float = 8.0e-9   # W per (V^2 * core Hz)


CONSTS = GpuModelConsts()


def train_time(v: Vehicle, batches: int, c: GpuModelConsts = CONSTS) -> float:
    """Eq. (6): one local-training pass of `batches` mini-batches."""
    return (c.t0 + c.c1 * batches * c.theta_mem / v.f_mem
            + c.c2 * batches * c.theta_core / v.f_core)


def runtime_power(v: Vehicle, c: GpuModelConsts = CONSTS) -> float:
    """Eq. (7)."""
    return c.p_g0 + c.zeta_mem * v.f_mem + c.zeta_core * v.v_core ** 2 * v.f_core


def train_energy(v: Vehicle, batches: int, c: GpuModelConsts = CONSTS) -> float:
    """Eq. (8): E = p * T."""
    return runtime_power(v, c) * train_time(v, batches, c)


# ---------------------------------------------------------------------------
# Vectorized variants (array-level SUBP1 selection / batched planner). Same
# float-op order as the scalar functions above, so results are bitwise equal
# elementwise.
# ---------------------------------------------------------------------------
def train_times(f_mem, f_core, batches: int,
                c: GpuModelConsts = CONSTS) -> "np.ndarray":
    """Eq. (6) over [N] frequency arrays."""
    return (c.t0 + c.c1 * batches * c.theta_mem / f_mem
            + c.c2 * batches * c.theta_core / f_core)


def runtime_powers(f_mem, f_core, v_core,
                   c: GpuModelConsts = CONSTS) -> "np.ndarray":
    """Eq. (7) over [N] capability arrays."""
    return c.p_g0 + c.zeta_mem * f_mem + c.zeta_core * v_core ** 2 * f_core


# RSU GPU: nominal vehicle-class core clock scaled by the Sec. IV-A5
# speedup. Named so the device planner (core/planner.py) derives the same
# eq. 13 constants as this reference instead of re-hard-coding them.
RSU_F_CORE = 1.5e9
RSU_SPEEDUP = 8.0


def rsu_train_time(batches: int, c: GpuModelConsts = CONSTS,
                   speedup: float = RSU_SPEEDUP) -> float:
    """Eq. (13): augmented-model training on the RSU GPU (faster than
    vehicle GPUs by `speedup`)."""
    return (c.t0 + (c.c1 * batches * c.theta_mem + c.c2 * batches * c.theta_core)
            / (RSU_F_CORE * speedup))
