"""Theorem 1 convergence upper bound (paper Sec. III-C2), a copy of the JAX
package's `core/convergence.py` (host float64 math, the same operations in
the same order, so the same bits).

L(w(T,Th)) - L(w*) <= chi^{hT} Theta + (1 - chi^{hT}) psi Lambda
  chi    = 1 - 2 mu eta + 2 mu rho eta^2          (rho = smoothness `varrho`)
  psi    = beta ((eta rho + 1)^h - 1) / (rho (1 + chi^h))
  Lambda = kappa1 sum_n rho_n (sigma_n + lambda_n) + kappa2 lambda_a

Requires eta < 1/rho for chi < 1 (contraction).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ConvergenceParams:
    beta: float = 1.0          # Lipschitz constant of L_n (Assumption 1)
    varrho: float = 10.0       # smoothness (Assumption 2)
    mu: float = 0.5            # strong convexity (Assumption 3)
    eta: float = 0.01          # learning rate (< 1/varrho)
    h: int = 4                 # local steps per round
    sigma: float = 0.1         # SGD variance bound (Assumption 5)
    lambda_a: float = 0.05     # AIGC model divergence bound (Assumption 4)
    theta: float = 1.0         # L(w0) - L(w*)


def chi(p: ConvergenceParams) -> float:
    return 1.0 - 2 * p.mu * p.eta + 2 * p.mu * p.varrho * p.eta ** 2


def psi(p: ConvergenceParams) -> float:
    c = chi(p)
    return p.beta * ((p.eta * p.varrho + 1) ** p.h - 1) / (p.varrho * (1 + c ** p.h))


def big_lambda(p: ConvergenceParams, rhos, lambdas, kappa1: float,
               kappa2: float) -> float:
    rhos = np.asarray(rhos, np.float64)
    lambdas = np.asarray(lambdas, np.float64)
    return float(kappa1 * np.sum(rhos * (p.sigma + lambdas)) + kappa2 * p.lambda_a)


def bound(p: ConvergenceParams, T: int, rhos, lambdas, kappa1: float,
          kappa2: float) -> float:
    """Theorem 1 RHS after T global rounds of h local steps."""
    if not p.eta < 1.0 / p.varrho:
        raise ValueError("Theorem 1 requires eta < 1/varrho")
    c = chi(p)
    lam = big_lambda(p, rhos, lambdas, kappa1, kappa2)
    decay = c ** (p.h * T)
    return decay * p.theta + (1.0 - decay) * psi(p) * lam


def bound_curve(p: ConvergenceParams, T_max: int, rhos, lambdas, kappa1,
                kappa2) -> np.ndarray:
    return np.array([bound(p, t, rhos, lambdas, kappa1, kappa2)
                     for t in range(T_max + 1)])
