"""SUBP1 selection and the SUBP2-4 block-coordinate descent of Algorithm 3
in NumPy (paper Sec. IV-V, eq. 6-13, 24-48).

Every function takes the configuration's constants as a dict `c` (the
configuration file's "genfv", "gpu_model" and "diffusion_service" groups,
merged, with the traffic mix's road overrides) and a NumPy float type `ft`:
float64, the precision the configuration states, or float32 for the
control. A vehicle is a mapping with the keys x (m), v (km/h), phi_max (W),
f_mem, f_core (Hz), v_core (V), gain_db, emd and data_size.
"""
from __future__ import annotations

import numpy as np


def _col(fleet, key, ft, idx=None):
    idx = range(len(fleet)) if idx is None else idx
    return np.array([fleet[i][key] for i in idx], ft)


# -- eq. 6-13, 25-27 ----------------------------------------------------------
def train_times(c, f_mem, f_core, batches):
    """Eq. 6."""
    return (c["t0"] + c["c1"] * batches * c["theta_mem"] / f_mem
            + c["c2"] * batches * c["theta_core"] / f_core)


def runtime_powers(c, f_mem, f_core, v_core):
    """Eq. 7."""
    return c["p_g0"] + c["zeta_mem"] * f_mem + c["zeta_core"] * v_core ** 2 * f_core


def rsu_train_time(c, batches):
    """Eq. 13: the augmented model's training on the RSU's GPU."""
    return (c["t0"] + (c["c1"] * batches * c["theta_mem"]
                       + c["c2"] * batches * c["theta_core"])
            / (c["rsu_f_core"] * c["rsu_speedup"]))


def t_per_image(c):
    """Eq. 12's t0."""
    return c["diffusion_steps"] * c["d_cycles"] / c["f_rsu"]


def noise_watts(c):
    return 10 ** ((c["noise_power_dbm"] - 30.0) / 10.0) * c["subcarrier_bw"]


def holding_times(c, x, v_kmh, ft=np.float64):
    """Eq. 25-26: remaining chord over speed."""
    half = ft(np.sqrt(c["rsu_radius"] ** 2 - c["rsu_road_offset"] ** 2))
    s = half - np.sign(v_kmh) * x
    return np.maximum(s, 0.0) / np.maximum(np.abs(v_kmh) / 3.6, 1e-9)


def distances(c, x):
    return np.hypot(x, c["rsu_road_offset"])


def b_primes(c, x, gain_db):
    return (c["unit_channel_gain"] * 10.0 ** (gain_db / 10.0)
            * distances(c, x) ** (-c["path_loss_exp"]) / noise_watts(c))


# -- SUBP1 ---------------------------------------------------------------------
def select_genfv(c, fleet, model_bits, batches, ft=np.float64) -> np.ndarray:
    """Eq. 27-30: alpha_n = 1 iff the nominal budget (one subcarrier, full
    power) fits min(t_hold, t_max) and EMD_n <= EMD_hat."""
    x, v = _col(fleet, "x", ft), _col(fleet, "v", ft)
    t_bar = np.minimum(holding_times(c, x, v, ft), c["t_max"])
    t_cp = train_times(c, _col(fleet, "f_mem", ft), _col(fleet, "f_core", ft), batches)
    h0 = c["unit_channel_gain"] * 10.0 ** (_col(fleet, "gain_db", ft) / 10.0)
    snr = (_col(fleet, "phi_max", ft) * h0 * distances(c, x) ** (-c["path_loss_exp"])
           / noise_watts(c))
    t_mu = model_bits / np.maximum(c["subcarrier_bw"] * np.log2(1.0 + snr), 1e-9)
    emd = _col(fleet, "emd", ft)
    return (~(emd > c["emd_threshold"]) & ~(t_cp + t_mu > t_bar)).astype(np.int32)


def select_random(rng: np.random.Generator, n: int, frac: float) -> np.ndarray:
    """FedAvg: `frac` of the fleet drawn uniformly without replacement."""
    alpha = np.zeros(n, np.int32)
    alpha[rng.choice(n, size=min(max(1, int(frac * n)), n), replace=False)] = 1
    return alpha


# -- SUBP2 (Algorithm 1) --------------------------------------------------------
def project_budget(l, M, l_min):
    pinned = np.zeros(l.shape[0], bool)
    for _ in range(l.shape[0]):
        s_pin = l_min * float(np.count_nonzero(pinned))
        s_free = float(l[~pinned].sum())
        if s_pin + s_free <= M:
            break
        scale = max(M - s_pin, 0.0) / max(s_free, 1e-300)
        l = np.where(pinned, l_min, l * scale).astype(l.dtype)
        newly = ~pinned & (l < l_min)
        if not newly.any():
            break
        pinned |= newly
        l = np.where(pinned, l_min, l).astype(l.dtype)
    return l


def solve_bandwidth(c, A, B, C, D):
    n, M, l_min = A.shape[0], c["num_subcarriers"], c["bw_l_min"]
    ft = A.dtype.type
    lam1, lam2, lam3 = np.ones(n, ft), 1.0, 1.0
    l = np.full(n, M / n, ft)
    prev = l.copy()
    for _ in range(c["bw_max_iter"]):
        l = np.sqrt((lam1 * B + ft(lam2) * D) / ft(max(lam3, 1e-9)))
        l = project_budget(np.clip(l, l_min, M), M, l_min)
        t_bar = float(np.max(A + B / l))
        g1 = A + B / l - ft(t_bar)
        g2 = float(np.sum(C + D / l) - c["e_max"] * n)
        g3 = float(l.sum() - M)
        lam1 = np.maximum(lam1 + c["bw_step"] * g1, 0.0) + ft(1e-12)
        lam2 = max(lam2 + c["bw_step"] * g2, 0.0) + 1e-12
        lam3 = max(lam3 + c["bw_step"] * g3, 1e-6)
        if np.max(np.abs(l - prev)) < c["bw_tol"]:
            return l
        prev = l.copy()
    return l


# -- SUBP3 (Algorithm 2) --------------------------------------------------------
def t_of_phi(bits, l_w, bp, phi):
    return bits / (l_w * np.log2(1.0 + bp * phi))


def solve_power(c, bits, l_w, bp, G, phi_max):
    ft = l_w.dtype.type
    phi = np.full(l_w.shape[0], c["phi_min"], ft)
    ln2 = ft(np.log(2.0))
    for _ in range(c["sca_max_iter"]):
        a, u = bits / l_w, bp * phi
        log2u = np.log2(1.0 + u)
        e_i = phi * t_of_phi(bits, l_w, bp, phi)
        de = a / log2u - a * bp * phi / (ln2 * (1.0 + u) * log2u ** 2)
        with np.errstate(divide="ignore", invalid="ignore"):
            budget = np.where(de > 1e-12, phi + (c["e_max"] - G - e_i) / de, phi_max)
        new = np.clip(np.minimum(budget, phi_max), c["phi_min"], phi_max).astype(ft)
        if np.max(np.abs(new - phi)) < c["sca_eps"]:
            return new
        phi = new
    return phi


# -- SUBP4 (eq. 48) and the whole Algorithm 3 ----------------------------------
def optimal_generation(c, t_bar, b_prev):
    budget = t_bar - rsu_train_time(c, max(b_prev // c["gen_batch"], 1))
    return 0 if budget <= 0 else int(np.floor(budget / t_per_image(c)))


def plan(c, fleet, alpha, model_bits, batches, b_prev, ft=np.float64) -> dict:
    """The SUBP2-4 BCD for the selected set `alpha` == 1; returns the
    selected indices, l, phi, t_bar, b_gen and t_rsu."""
    idx = [i for i in range(len(fleet)) if alpha[i] == 1]
    if not idx:
        return {"selected": [], "l": np.zeros(0), "phi": np.zeros(0),
                "t_bar": 0.0, "b_gen": 0, "t_rsu": 0.0}
    x = _col(fleet, "x", ft, idx)
    f_mem, f_core = _col(fleet, "f_mem", ft, idx), _col(fleet, "f_core", ft, idx)
    t_cp = train_times(c, f_mem, f_core, batches)
    e_cp = runtime_powers(c, f_mem, f_core, _col(fleet, "v_core", ft, idx)) * t_cp
    bp = b_primes(c, x, _col(fleet, "gain_db", ft, idx)).astype(ft)
    phi_max = _col(fleet, "phi_max", ft, idx)
    bits, W = ft(model_bits), ft(c["subcarrier_bw"])
    l = np.full(len(idx), c["num_subcarriers"] / len(idx), ft)
    phi, b_gen = phi_max.copy(), b_prev
    for _ in range(c["bcd_max_iter"]):
        l_old, phi_old, b_old = l.copy(), phi.copy(), b_gen
        Bt = bits / (W * np.log2(1.0 + bp * phi))
        l = solve_bandwidth(c, t_cp, Bt, e_cp, phi * Bt)
        phi = solve_power(c, bits, l * W, bp, e_cp, phi_max)
        t_bar = float(np.max(t_cp + t_of_phi(bits, l * W, bp, phi)))
        b_gen = optimal_generation(c, min(t_bar, c["t_max"]), b_old)
        if (np.max(np.abs(l - l_old)) < c["bcd_eps"]
                and np.max(np.abs(phi - phi_old)) < c["bcd_eps"]
                and abs(b_gen - b_old) < 1):
            break
    t_bar = float(np.max(t_cp + t_of_phi(bits, l * W, bp, phi)))
    t_rsu = b_gen * t_per_image(c) + rsu_train_time(c, max(b_gen // c["gen_batch"], 1))
    return {"selected": idx, "l": l, "phi": phi, "t_bar": t_bar,
            "b_gen": int(b_gen), "t_rsu": float(t_rsu)}


def label_schedule(b: int, classes: int) -> np.ndarray:
    """Uniform per-label counts of the b generated images (Sec. V-B4)."""
    out = np.full(classes, b // classes, np.int64)
    out[: b % classes] += 1
    return out


def kappas(emd_bar: float) -> tuple[float, float]:
    """Eq. 4: kappa2 = (EMD_bar / 2)^2 in [0, 1], kappa1 = 1 - kappa2."""
    k2 = min(max((emd_bar / 2.0) ** 2, 0.0), 1.0)
    return 1.0 - k2, k2
