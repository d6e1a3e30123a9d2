"""Vehicle mobility model (paper Sec. V-A2, eq. 24-27, Fig. 3).

Vehicles arrive as a Poisson process; average speed depends on road load
(eq. 24); individual speeds are truncated-normal around the average; the V2R
holding time is the remaining in-coverage distance over speed (eq. 25-26).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import GenFVConfig


@dataclass
class Vehicle:
    vid: int
    x: float              # signed position along the road, 0 = RSU foot (m)
    v: float              # signed velocity (m/s); sign = direction
    phi_max: float        # max uplink tx power (W)
    f_mem: float          # GPU memory frequency (Hz)
    f_core: float         # GPU core frequency (Hz)
    v_core: float         # GPU core voltage (V)
    data_size: int        # |D_n|
    hist: np.ndarray      # label histogram p_n(y)
    emd: float            # EMD_n
    gain_db: float = 0.0  # slow-fading shadowing offset on h0 (dB; sim layer)


def average_speed(cfg: GenFVConfig, m_on_road: int) -> float:
    """Eq. (24): v_bar = max(v_max (1 - M/M_max), v_min), in km/h."""
    return max(cfg.v_max * (1.0 - m_on_road / cfg.m_max), cfg.v_min)


def sample_speeds(rng: np.random.Generator, cfg: GenFVConfig, n: int,
                  m_on_road: int) -> np.ndarray:
    """Truncated-normal speeds (km/h): sigma = k v_bar, floor at v_min."""
    v_bar = average_speed(cfg, m_on_road)
    sigma = cfg.sigma_k * v_bar
    v = rng.normal(v_bar, sigma, size=n)
    return np.clip(v, cfg.v_min, cfg.v_max)


def coverage_half_length(cfg: GenFVConfig) -> float:
    """sqrt(r^2 - e^2): half of the RSU's coverage chord on the road."""
    return float(np.sqrt(cfg.rsu_radius ** 2 - cfg.rsu_road_offset ** 2))


def remaining_distance(cfg: GenFVConfig, x: float, v: float) -> float:
    """Eq. (25): s_n = sqrt(r^2-e^2) - sign(v) * x."""
    half = coverage_half_length(cfg)
    return half - np.sign(v) * x


def holding_time(cfg: GenFVConfig, x: float, v_kmh: float) -> float:
    """Eq. (26): t_hold = s_n / |v_n| (seconds; v in km/h -> m/s)."""
    v_ms = abs(v_kmh) / 3.6
    s = remaining_distance(cfg, x, v_kmh)
    return float(max(s, 0.0) / max(v_ms, 1e-9))


def rsu_distance(cfg: GenFVConfig, x: float) -> float:
    """Euclidean distance vehicle -> RSU (for the path-loss model)."""
    return float(np.hypot(x, cfg.rsu_road_offset))


# ---------------------------------------------------------------------------
# Vectorized variants (repro.sim world stepping / dropout accounting). Same
# math as the scalar functions above, applied elementwise to [N] arrays.
# ---------------------------------------------------------------------------
def remaining_distances(cfg: GenFVConfig, x: np.ndarray,
                        v: np.ndarray) -> np.ndarray:
    """Eq. (25) over arrays: s_n = sqrt(r^2-e^2) - sign(v_n) * x_n."""
    half = coverage_half_length(cfg)
    return half - np.sign(v) * np.asarray(x, np.float64)


def holding_times(cfg: GenFVConfig, x: np.ndarray,
                  v_kmh: np.ndarray) -> np.ndarray:
    """Eq. (26) over arrays: t_hold = max(s_n, 0) / max(|v_n|, eps)."""
    v_ms = np.abs(np.asarray(v_kmh, np.float64)) / 3.6
    s = remaining_distances(cfg, x, v_kmh)
    return np.maximum(s, 0.0) / np.maximum(v_ms, 1e-9)


def rsu_distances(cfg: GenFVConfig, x: np.ndarray) -> np.ndarray:
    """Euclidean vehicle -> RSU distance over an [N] position array."""
    return np.hypot(np.asarray(x, np.float64), cfg.rsu_road_offset)


def sample_fleet(rng: np.random.Generator, cfg: GenFVConfig, hists,
                 sizes) -> list[Vehicle]:
    """Sample the in-range fleet: Poisson count (capped to available data
    partitions), uniform positions on the coverage chord, eq.-24 speeds,
    random GPU/radio capabilities (Sec. VI-A3 ranges)."""
    n_avail = len(sizes)
    draw = rng.poisson(cfg.num_vehicles)
    n = min(max(draw, 1), n_avail)
    half = coverage_half_length(cfg)
    xs = rng.uniform(-half, half, size=n)
    dirs = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    # eq. 24 road load uses the UNCAPPED Poisson draw: capping to the number
    # of available data partitions bounds how many vehicles can be FL clients,
    # but the extra vehicles are still physically on the road and congest it.
    speeds = sample_speeds(rng, cfg, n, m_on_road=max(draw, 1)) * dirs
    fleet = []
    for i in range(n):
        hist = np.asarray(hists[i], np.float64)
        p_glob = np.full_like(hist, 1.0 / hist.shape[0])
        fleet.append(Vehicle(
            vid=i,
            x=float(xs[i]),
            v=float(speeds[i]),
            phi_max=float(rng.uniform(cfg.phi_min, cfg.phi_max)),
            f_mem=float(rng.uniform(1.25e9, 1.75e9)),
            f_core=float(rng.uniform(1.0e9, 1.6e9)),
            v_core=float(rng.uniform(0.8, 1.1)),
            data_size=int(sizes[i]),
            hist=hist,
            emd=float(np.abs(hist - p_glob).sum()),
        ))
    return fleet
