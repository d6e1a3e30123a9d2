"""SUBP1 — large-communication-scale vehicle selection (paper Sec. V-A).

alpha_n = 1  iff  (T_n^cp + T_n^mu <= T_bar_n) AND (EMD_n <= EMD_hat)
with T_bar_n = min(t_hold_n, t_max)  (eq. 27-30).

Feasibility is checked with nominal resources (one subcarrier, max power),
since bandwidth/power are only optimized for the *selected* set afterwards.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from repro_torch.configs.base import GenFVConfig
from repro_torch.core import channel, gpu_model, mobility
from repro_torch.core.mobility import Vehicle


@dataclass
class SelectionResult:
    alpha: np.ndarray                # [N] {0,1}
    t_bar: np.ndarray                # [N] per-vehicle deadline (eq. 27)
    t_cp: np.ndarray                 # nominal train time
    t_mu: np.ndarray                 # nominal upload time
    t_hold: np.ndarray | None = None  # [N] raw eq.-26 holding time (dropout
                                      # accounting: t_bar caps it at t_max)
    # lazy reason strings: (vids, emds, emd_hat) kept so the per-vehicle
    # explanation is only formatted when someone actually reads it (the hot
    # planner path never does)
    _reason_ctx: tuple | None = field(default=None, repr=False)
    _reasons: List[str] | None = field(default=None, repr=False)

    @property
    def reasons(self) -> List[str]:
        """Why each vehicle was kept/dropped (formatted on first access)."""
        if self._reasons is None:
            vids, emds, emd_hat = self._reason_ctx or ([], [], 0.0)
            total = self.t_cp + self.t_mu
            out = []
            for i, vid in enumerate(vids):
                if emds[i] > emd_hat:
                    out.append(
                        f"v{vid}: dropped (EMD {emds[i]:.2f} > {emd_hat})")
                elif total[i] > self.t_bar[i]:
                    out.append(f"v{vid}: dropped (T {total[i]:.2f}s > "
                               f"Tbar {self.t_bar[i]:.2f}s)")
                else:
                    out.append(f"v{vid}: selected")
            self._reasons = out
        return self._reasons


def select(cfg: GenFVConfig, fleet: List[Vehicle], model_bits: float,
           batches: int, emd_hat: float | None = None) -> SelectionResult:
    emd_hat = cfg.emd_threshold if emd_hat is None else emd_hat
    xs = np.array([v.x for v in fleet], np.float64)
    vs = np.array([v.v for v in fleet], np.float64)
    phi_max = np.array([v.phi_max for v in fleet], np.float64)
    f_mem = np.array([v.f_mem for v in fleet], np.float64)
    f_core = np.array([v.f_core for v in fleet], np.float64)
    gain_db = np.array([v.gain_db for v in fleet], np.float64)
    emds = np.array([v.emd for v in fleet], np.float64)
    vids = [v.vid for v in fleet]

    # eq. 26-27 deadline + nominal single-subcarrier/max-power budget, all
    # array-level (the vectorized helpers mirror the scalar float-op order,
    # so alpha is bitwise-identical to the per-vehicle reference loop)
    t_hold = mobility.holding_times(cfg, xs, vs)
    t_bar = np.minimum(t_hold, cfg.t_max)
    t_cp = gpu_model.train_times(f_mem, f_core, batches)
    dists = mobility.rsu_distances(cfg, xs)
    t_mu = channel.upload_times(cfg, model_bits, 1.0, phi_max, dists,
                                gain_db=gain_db)
    alpha = (~(emds > emd_hat) & ~(t_cp + t_mu > t_bar)).astype(np.int32)
    return SelectionResult(alpha, t_bar, t_cp, t_mu, t_hold,
                           _reason_ctx=(vids, emds, emd_hat))


def dropout_mask(cfg: GenFVConfig, fleet: List[Vehicle],
                 selected: List[int], t_round: float) -> np.ndarray:
    """Survival mask over `selected`: True where the vehicle's eq.-26 holding
    time covers the realized round duration `t_round`.

    SUBP1 admits vehicles whose *nominal* budget fits inside min(t_hold,
    t_max), but the realized straggler window t_bar is only known after
    SUBP2-4 run for the selected set — a vehicle can leave coverage before
    the synchronous round closes anyway, and its update is discarded
    (commit-at-window-end semantics; rationale in DESIGN.md §repro.sim).
    repro.sim threads the dropout count into RoundLog.
    """
    if not selected:
        return np.zeros(0, bool)
    xs = np.array([fleet[i].x for i in selected])
    vs = np.array([fleet[i].v for i in selected])
    return mobility.holding_times(cfg, xs, vs) >= t_round


def select_random(rng: np.random.Generator, fleet, k: int) -> np.ndarray:
    """FedAvg baseline: uniform random selection of k vehicles."""
    alpha = np.zeros(len(fleet), np.int32)
    idx = rng.choice(len(fleet), size=min(k, len(fleet)), replace=False)
    alpha[idx] = 1
    return alpha


def select_no_emd(cfg: GenFVConfig, fleet, model_bits: float,
                  batches: int) -> np.ndarray:
    """'No EMD' baseline: keep only the deadline constraint (eq. 28)."""
    res = select(cfg, fleet, model_bits, batches, emd_hat=np.inf)
    return res.alpha


def select_madca(cfg: GenFVConfig, fleet, model_bits: float, batches: int,
                 success_prob: float = 0.8) -> np.ndarray:
    """MADCA-FL-style baseline [5]: select vehicles whose probability of
    finishing within their holding time exceeds `success_prob`, ignoring
    data heterogeneity. Completion probability is estimated from the
    speed-noise model (sigma = k*v)."""
    alpha = np.zeros(len(fleet), np.int32)
    for i, v in enumerate(fleet):
        t_need = (gpu_model.train_time(v, batches)
                  + channel.upload_time(cfg, model_bits, 1.0, v.phi_max,
                                        mobility.rsu_distance(cfg, v.x),
                                        gain_db=v.gain_db))
        # holding time at +/- 1.28 sigma speed (10%/90% quantiles)
        s = mobility.remaining_distance(cfg, v.x, v.v)
        v_hi = abs(v.v) * (1 + 1.28 * cfg.sigma_k) / 3.6
        t_hold_lo = max(s, 0.0) / max(v_hi, 1e-9)
        p_ok = 1.0 if t_need <= t_hold_lo else (
            0.0 if t_need > mobility.holding_time(cfg, v.x, v.v) else 0.5)
        if p_ok >= success_prob and t_need <= cfg.t_max:
            alpha[i] = 1
    return alpha


def select_ocean(cfg: GenFVConfig, fleet, model_bits: float, batches: int,
                 round_idx: int, total_rounds: int) -> np.ndarray:
    """OCEAN-a-style baseline [30]: long-term energy-aware selection with a
    'later-is-better' participation ramp — the admitted fraction grows with
    the round index."""
    frac = 0.3 + 0.7 * min(round_idx / max(total_rounds - 1, 1), 1.0)
    scores = []
    for v in fleet:
        e = (gpu_model.train_energy(v, batches)
             + channel.upload_energy(cfg, model_bits, 1.0, v.phi_max,
                                     mobility.rsu_distance(cfg, v.x),
                                     gain_db=v.gain_db))
        scores.append(e)
    order = np.argsort(scores)                      # cheapest energy first
    k = max(1, int(round(frac * len(fleet))))
    alpha = np.zeros(len(fleet), np.int32)
    alpha[order[:k]] = 1
    return alpha
