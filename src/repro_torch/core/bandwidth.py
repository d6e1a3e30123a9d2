"""SUBP2 — bandwidth (subcarrier) allocation by Lagrange multipliers / KKT
(paper Sec. V-B2, eq. 33-38, Algorithm 1).

min_{l} T_bar  s.t.  A_n + B_n/l_n <= T_bar  (delay),
                     C_n + D_n/l_n <= E_bar  (energy),
                     sum l_n <= M,  l_n >= l_min.

KKT stationarity gives l_n* = sqrt((lambda1_n B_n + lambda2 D_n)/lambda3)
(eq. 38); the multipliers are driven by projected subgradient ascent
(Algorithm 1). The relaxed fractional l_n is the paper's expected number of
subcarriers (eq. 35).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BandwidthResult:
    l: np.ndarray          # [N] fractional subcarriers
    t_bar: float           # resulting max delay
    iters: int
    converged: bool


def project_budget(l: np.ndarray, M: float, l_min: float) -> np.ndarray:
    """Project l onto {sum l <= M, l >= l_min} by iterated rescaling.

    Precondition: the input already satisfies l >= l_min (solve_bandwidth
    clips to [l_min, M] before projecting) — an already-under-budget input
    is returned untouched, so entries below the floor stay there.

    A single rescale `l * (M / sum(l))` followed by the l_min floor can
    leave sum(l) > M when the floor binds on some entries after rescaling.
    Water-fill instead: pin floored entries at l_min and rescale the rest
    into the remaining budget until no new entry falls below the floor.
    When no floor binds this is exactly the single rescale. If the budget
    is infeasible (n * l_min > M) every entry pins at l_min — the floor
    constraint wins, and sum(l) = n * l_min is the best achievable.
    """
    pinned = np.zeros(l.shape[0], bool)
    for _ in range(l.shape[0]):
        s_pin = l_min * float(np.count_nonzero(pinned))
        s_free = float(l[~pinned].sum())
        if s_pin + s_free <= M:
            break
        scale = max(M - s_pin, 0.0) / max(s_free, 1e-300)
        l = np.where(pinned, l_min, l * scale)
        newly = ~pinned & (l < l_min)
        if not newly.any():
            break
        pinned |= newly
        l = np.where(pinned, l_min, l)
    return l


def solve_bandwidth(A: np.ndarray, B: np.ndarray, C: np.ndarray,
                    D: np.ndarray, M: float, e_bar: float,
                    l_min: float = 0.05, step: float = 0.05,
                    max_iter: int = 500, tol: float = 1e-5) -> BandwidthResult:
    """A,B: delay terms; C,D: energy terms (per selected vehicle)."""
    n = A.shape[0]
    if n == 0:
        return BandwidthResult(np.zeros(0), 0.0, 0, True)
    lam1 = np.ones(n)
    lam2 = 1.0
    lam3 = 1.0
    l = np.full(n, M / n)
    prev = l.copy()
    it = 0
    for it in range(1, max_iter + 1):
        # eq. (38)
        l = np.sqrt((lam1 * B + lam2 * D) / max(lam3, 1e-9))
        l = np.clip(l, l_min, M)
        l = project_budget(l, M, l_min)
        t_bar = float(np.max(A + B / l))
        # subgradient ascent on the multipliers (Algorithm 1 lines 2-4)
        g1 = A + B / l - t_bar                  # <=0 slack per vehicle
        g2 = float(np.sum(C + D / l) - e_bar * n)
        g3 = float(l.sum() - M)
        lam1 = np.maximum(lam1 + step * g1, 0.0) + 1e-12
        lam2 = max(lam2 + step * g2, 0.0) + 1e-12
        lam3 = max(lam3 + step * g3, 1e-6)
        if np.max(np.abs(l - prev)) < tol:
            return BandwidthResult(l, t_bar, it, True)
        prev = l.copy()
    return BandwidthResult(l, float(np.max(A + B / l)), it, False)


def equal_share(n: int, M: float) -> np.ndarray:
    """Baseline: uniform split of the M subcarriers."""
    return np.full(n, M / max(n, 1))
