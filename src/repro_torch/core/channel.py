"""OFDMA uplink model (paper Sec. IV-A4, eq. 9-11).

r_n = l_n W log2(1 + phi_n h0 d_n^-gamma / N0)
T_mu = s(omega) / r_n ;  E_mu = phi_n T_mu

`gain_db` is a slow-fading shadowing offset on the unit channel gain h0
(0 dB = the paper's memoryless nominal channel). The repro.sim world evolves
it per vehicle as an AR(1) log-normal process so SNR is time-correlated
between rounds; the legacy path always passes 0, where 10^(0/10) = 1.0
multiplies exactly and reproduces the seed numbers bitwise.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import GenFVConfig


def noise_watts(cfg: GenFVConfig) -> float:
    """Noise power over one subchannel: N0[dBm/Hz] integrated over W."""
    psd = 10 ** ((cfg.noise_power_dbm - 30.0) / 10.0)   # W/Hz
    return psd * cfg.subcarrier_bw


def shadow_linear(gain_db) -> float | np.ndarray:
    """dB shadowing offset -> linear multiplier on h0."""
    return 10.0 ** (np.asarray(gain_db, np.float64) / 10.0)


def snr(cfg: GenFVConfig, phi: float, dist: float,
        gain_db: float = 0.0) -> float:
    """phi h0 d^-gamma / N0 (eq. 9 inner term), h0 shadowed by gain_db."""
    h0 = cfg.unit_channel_gain * shadow_linear(gain_db)
    return phi * h0 * dist ** (-cfg.path_loss_exp) / noise_watts(cfg)


def uplink_rate(cfg: GenFVConfig, l_n: float, phi: float, dist: float,
                gain_db: float = 0.0) -> float:
    """Eq. (9): bits/s given l_n subcarriers (fractional l_n allowed by the
    SUBP2 relaxation), power phi (W) and distance dist (m)."""
    return l_n * cfg.subcarrier_bw * np.log2(1.0 + snr(cfg, phi, dist, gain_db))


def upload_time(cfg: GenFVConfig, model_bits: float, l_n: float, phi: float,
                dist: float, gain_db: float = 0.0) -> float:
    """Eq. (10)."""
    r = uplink_rate(cfg, l_n, phi, dist, gain_db)
    return float(model_bits / max(r, 1e-9))


def upload_energy(cfg: GenFVConfig, model_bits: float, l_n: float, phi: float,
                  dist: float, gain_db: float = 0.0) -> float:
    """Eq. (11)."""
    return float(phi * upload_time(cfg, model_bits, l_n, phi, dist, gain_db))


# ---------------------------------------------------------------------------
# Vectorized variants (array-level SUBP1 selection / batched planner). Same
# float-op order as the scalar chain above, so results are bitwise equal
# elementwise.
# ---------------------------------------------------------------------------
def snrs(cfg: GenFVConfig, phi, dist, gain_db=0.0) -> np.ndarray:
    """Eq. (9) inner term over [N] arrays."""
    h0 = cfg.unit_channel_gain * shadow_linear(gain_db)
    return phi * h0 * np.asarray(dist, np.float64) ** (-cfg.path_loss_exp) \
        / noise_watts(cfg)


def upload_times(cfg: GenFVConfig, model_bits: float, l_n, phi, dist,
                 gain_db=0.0) -> np.ndarray:
    """Eq. (10) over [N] arrays."""
    r = l_n * cfg.subcarrier_bw * np.log2(1.0 + snrs(cfg, phi, dist, gain_db))
    return model_bits / np.maximum(r, 1e-9)
