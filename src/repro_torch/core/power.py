"""SUBP3 — transmission-power assignment by Successive Convex Approximation
(paper Sec. V-B3, eq. 39-46, Algorithm 2).

Non-convex terms:
    t(phi) = s(w) / (l W log2(1 + B' phi))        (upload delay)
    e(phi) = phi t(phi)                            (upload energy)
are replaced by first-order Taylor expansions around phi^i each iteration;
the resulting convex subproblem has the closed form: push phi up (delay
decreases monotonically) until the linearized energy budget or phi_max
binds. Iterate to a fixed point (Algorithm 2).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PowerResult:
    phi: np.ndarray
    t_bar: float
    iters: int
    converged: bool


def t_of_phi(s_bits: float, l_w: np.ndarray, b_prime: np.ndarray,
             phi: np.ndarray) -> np.ndarray:
    """Eq. (41): upload delay; l_w = l_n * W (allocated bandwidth, Hz)."""
    return s_bits / (l_w * np.log2(1.0 + b_prime * phi))


def t_prime(s_bits: float, l_w: np.ndarray, b_prime: np.ndarray,
            phi: np.ndarray) -> np.ndarray:
    """Eq. (43): dt/dphi (negative)."""
    a = s_bits / l_w
    u = b_prime * phi
    return -a * b_prime * np.log(2.0) / ((1.0 + u) * np.log(1.0 + u) ** 2)


def e_of_phi(s_bits: float, l_w, b_prime, phi) -> np.ndarray:
    """Eq. (44)."""
    return phi * t_of_phi(s_bits, l_w, b_prime, phi)


def e_prime(s_bits: float, l_w, b_prime, phi) -> np.ndarray:
    """Eq. (46): de/dphi."""
    a = s_bits / l_w
    u = b_prime * phi
    log2u = np.log2(1.0 + u)
    return a / log2u - a * b_prime * phi / (np.log(2.0) * (1.0 + u) * log2u ** 2)


def solve_power(s_bits: float, l_w: np.ndarray, b_prime: np.ndarray,
                G: np.ndarray, e_bar: float, phi_min: float, phi_max,
                max_iter: int = 50, eps: float = 1e-4) -> PowerResult:
    """Algorithm 2. G: non-transmission energy (training); per-vehicle
    budget: G + e(phi) <= e_bar. phi_max may be scalar or per-vehicle."""
    n = l_w.shape[0]
    if n == 0:
        return PowerResult(np.zeros(0), 0.0, 0, True)
    phi_max = np.broadcast_to(np.asarray(phi_max, np.float64), (n,))
    phi = np.full(n, phi_min, np.float64)
    it = 0
    converged = False   # explicit: a fixed point reached exactly on the
    for it in range(1, max_iter + 1):   # last iteration still counts
        e_i = e_of_phi(s_bits, l_w, b_prime, phi)
        de = e_prime(s_bits, l_w, b_prime, phi)
        # linearized budget: G + e_i + de*(phi_new - phi) <= e_bar
        slack = e_bar - G - e_i
        with np.errstate(divide="ignore", invalid="ignore"):
            phi_budget = np.where(de > 1e-12, phi + slack / de, phi_max)
        phi_new = np.clip(np.minimum(phi_budget, phi_max), phi_min, phi_max)
        if np.max(np.abs(phi_new - phi)) < eps:
            phi = phi_new
            converged = True
            break
        phi = phi_new
    t_bar = float(np.max(t_of_phi(s_bits, l_w, b_prime, phi)))
    return PowerResult(phi, t_bar, it, converged)
