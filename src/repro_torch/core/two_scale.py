"""Algorithm 3 — Joint Two-Scale Algorithm (paper Sec. V-C).

Large communication scale: label sharing + SUBP1 vehicle selection.
Small computation scale:   BCD over SUBP2 (bandwidth) -> SUBP3 (power)
                           -> SUBP4 (generation) until all three deltas
                           fall below the epsilons.

Outputs a `RoundPlan`: who participates, their subcarriers/powers, the
number of images the RSU generates, and the full delay/energy ledger that
the FL runtime uses as the simulated round clock.

Two backends solve the small scale:
  planner="torch" (default) — the batched device planner in
                  core/planner.py, float64 on the device the caller names;
                  the counterpart of the JAX package's planner="jax".
  planner="numpy" — the host reference loop below, a copy of the JAX
                  package's; it pins the paper math, and the device planner
                  is held to it (DESIGN.md §"The numpy-reference contract").
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.configs.base import GenFVConfig
from repro_torch.core import bandwidth as bw
from repro_torch.core import power as pw
from repro_torch.core.generation import DiffusionService, inference_time, \
    optimal_generation
from repro_torch.core.gpu_model import rsu_train_time
from repro_torch.core.mobility import Vehicle
from repro_torch.core.planner import (RoundPlan, empty_plan,
                                      plan_rounds_batched,
                                      plan_selected_torch, selected_consts)
from repro_torch.core.selection import select

__all__ = ["RoundPlan", "plan_round", "plan_rounds_batched"]


def plan_round(cfg: GenFVConfig, fleet: List[Vehicle], model_bits: float,
               batches: int, b_prev: int = 0,
               svc: DiffusionService | None = None,
               eps: float | None = None, max_bcd: int | None = None,
               alpha_override: np.ndarray | None = None,
               planner: str = "torch", device="cuda") -> RoundPlan:
    """SUBP1 selection (unless `alpha_override` gives it) and the SUBP2-4
    BCD. `device` is where the torch planner runs; numpy ignores it."""
    svc = svc or DiffusionService(steps=cfg.diffusion_steps)
    eps = cfg.bcd_eps if eps is None else eps
    max_bcd = cfg.bcd_max_iter if max_bcd is None else max_bcd
    if planner not in ("torch", "numpy"):
        raise ValueError(f"unknown planner {planner!r}")

    # ---- Large communication scale: label share + SUBP1 ------------------
    # With an alpha_override the caller already ran strategy-specific
    # selection (fl/rounds.py), so re-running SUBP1 here would double the
    # selection work per round; plan.selection is None in that case.
    if alpha_override is None:
        sel = select(cfg, fleet, model_bits, batches)
        alpha = sel.alpha
    else:
        sel = None
        alpha = np.asarray(alpha_override)
    idx = [i for i in range(len(fleet)) if alpha[i] == 1]
    if not idx:
        return empty_plan(alpha, sel)

    # ---- constants per selected vehicle (hoisted out of the BCD) ---------
    c = selected_consts(cfg, fleet, idx, batches)

    # ---- Small computation scale: BCD over SUBP2/3/4 ----------------------
    if planner == "torch":
        r = plan_selected_torch(cfg, model_bits, c, b_prev, svc, eps, max_bcd,
                                device=device)
        return RoundPlan(alpha=alpha, selected=idx, l=r["l"], phi=r["phi"],
                         b_gen=r["b_gen"], t_cp=c.t_cp, t_mu=r["t_mu"],
                         t_bar=r["t_bar"], e_total=c.e_cp + r["e_mu"],
                         t_rsu=r["t_rsu"], bcd_iters=r["bcd_iters"],
                         converged=r["converged"], history=r["history"],
                         selection=sel, syncs=r["syncs"])

    K = len(idx)
    t_cp, e_cp, b_prime, phi_max = c.t_cp, c.e_cp, c.b_prime, c.phi_max
    l = bw.equal_share(K, cfg.num_subcarriers)
    phi = phi_max.copy()
    b_gen = b_prev
    history: List[float] = []
    it = 0
    for it in range(1, max_bcd + 1):
        l_old, phi_old, b_old = l.copy(), phi.copy(), b_gen

        # SUBP2: bandwidth given phi, b
        rate_1sub = cfg.subcarrier_bw * np.log2(1.0 + b_prime * phi)
        B = model_bits / rate_1sub                 # T_mu = B / l_n
        D = phi * B                                # E_mu = D / l_n
        res2 = bw.solve_bandwidth(t_cp, B, e_cp, D, cfg.num_subcarriers,
                                  cfg.e_max, l_min=cfg.bw_l_min,
                                  step=cfg.bw_step, max_iter=cfg.bw_max_iter,
                                  tol=cfg.bw_tol)
        l = res2.l

        # SUBP3: power given l, b
        res3 = pw.solve_power(model_bits, l * cfg.subcarrier_bw, b_prime,
                              e_cp, cfg.e_max, cfg.phi_min, phi_max,
                              max_iter=cfg.sca_max_iter, eps=cfg.sca_eps)
        phi = res3.phi

        # SUBP4: generation given l, phi (closed form, eq. 48)
        t_mu = pw.t_of_phi(model_bits, l * cfg.subcarrier_bw, b_prime, phi)
        t_bar = float(np.max(t_cp + t_mu))
        b_gen = optimal_generation(min(t_bar, cfg.t_max), b_old, svc,
                                   cfg.gen_batch)
        history.append(t_bar)

        if (np.max(np.abs(l - l_old)) < eps
                and np.max(np.abs(phi - phi_old)) < eps
                and abs(b_gen - b_old) < 1):
            break

    t_mu = pw.t_of_phi(model_bits, l * cfg.subcarrier_bw, b_prime, phi)
    e_mu = phi * t_mu
    t_bar = float(np.max(t_cp + t_mu))
    t_rsu = inference_time(svc, b_gen) + rsu_train_time(
        max(b_gen // cfg.gen_batch, 1))
    # `it < max_bcd` matches the torch backend's host-side convergence
    # definition (conservative when the break lands on the final iteration)
    return RoundPlan(alpha=alpha, selected=idx, l=l, phi=phi, b_gen=b_gen,
                     t_cp=t_cp, t_mu=t_mu, t_bar=t_bar,
                     e_total=e_cp + e_mu, t_rsu=t_rsu, bcd_iters=it,
                     converged=it < max_bcd, history=history, selection=sel)
