"""Theorem-1 analysis as a first-class object, the counterpart of the JAX
package's `exp/analysis.py` (host float64 math, the same operations in the
same order, so the same bits on the same sweep result).

`theorem1_comparison(result)` evaluates the paper's convergence upper bound
(core/convergence.py, Theorem 1) against each sweep cell's *realized* loss
curve and aggregates bound tightness per scenario: the
scenario-conditioned convergence-bound comparison as one call on a
`SweepResult`.

How the bound's inputs are read off a cell (honest approximations, since
the theorem's constants are not observable from training logs):

* ``h``            — the cell's realized `local_steps` (recorded by Sweep);
* ``lambda_n``     — the paper's divergence bound `EMD_n * g_n` with the
  realized per-round mean EMD of the cell and a shared gradient scale
  ``g_n``;
* ``kappa1/kappa2``— the cell's realized mean aggregation weights;
* ``L(w*)``        — proxied by a sweep-level lower envelope: the minimum
  loss observed anywhere in the sweep minus a 5% loss-range margin (the
  optimum is strictly below anything training reached; without the margin
  the best cell's final gap is zero by construction and its tightness
  ratio diverges);
* ``Theta``        — the cell's first-round gap to that proxy.

The output rows therefore measure *tightness* (bound / realized gap) and
*validity* (fraction of rounds where the bound sits above the realized
gap), not exact constants — which is exactly what the paper's Fig.-style
bound plots communicate.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import convergence
from repro_torch.exp.artifacts import save_artifact, schema_tag
from repro_torch.exp.sweep import SweepResult

THEOREM1_SCHEMA = schema_tag("theorem1")   # repro_torch.exp/theorem1/v1


def optimal_kappa2(p: convergence.ConvergenceParams, T: int, rhos, lams,
                   n_grid: int = 21) -> tuple[float, float]:
    """Grid-minimize the Theorem-1 bound over the aggregation weight kappa2
    (the eq.-4 justification: an interior optimum exists when lambda_a is
    below the fleet-average divergence). Returns (kappa2*, bound*)."""
    grid = [(k2, convergence.bound(p, T, rhos, lams, 1.0 - k2, k2))
            for k2 in np.linspace(0.0, 1.0, n_grid)]
    k2_star, b_star = min(grid, key=lambda g: g[1])
    return float(k2_star), float(b_star)


def per_scenario_markdown(rows) -> str:
    """Markdown table for per-scenario aggregate rows (the dicts produced
    by `Theorem1Report.per_scenario()` / stored in theorem1 artifacts)."""
    lines = ["| scenario | cells | EMD̄ | bound(T) | realized(T) | "
             "tightness | valid |",
             "|---|---|---|---|---|---|---|"]
    for row in rows:
        lines.append(
            f"| {row['scenario']} | {row['cells']} | "
            f"{row['emd_bar']:.2f} | {row['bound_final']:.4f} | "
            f"{row['realized_final']:.4f} | {row['tightness']:.2f}x | "
            f"{row['valid_fraction'] * 100:.0f}% |")
    return "\n".join(lines)


@dataclass
class BoundRow:
    """Bound-vs-realized comparison for one sweep cell."""
    index: int
    strategy: str
    scenario: str
    alpha: float
    seed: int
    rounds: int
    h: int
    emd_bar: float                 # realized mean EMD over rounds
    kappa2: float                  # realized mean aggregation weight
    theta: float                   # first-round gap (bound's Theta)
    bound_final: float             # Theorem-1 RHS after `rounds` rounds
    realized_final: float          # realized final gap to the L* proxy
    tightness: float               # bound_final / realized_final
    valid_fraction: float          # P_t[bound_t >= realized gap_t]
    bound_curve: List[float] = field(default_factory=list)
    realized_curve: List[float] = field(default_factory=list)


@dataclass
class Theorem1Report:
    params: Dict[str, float]       # shared ConvergenceParams fields
    loss_star: float               # the sweep-level L(w*) proxy
    g_n: float
    rows: List[BoundRow]
    meta: Dict[str, object] = field(default_factory=dict)

    # ------------------------------------------------------------------
    def per_scenario(self) -> List[Dict[str, float]]:
        """Aggregate bound tightness per scenario."""
        out = []
        for scen in sorted({r.scenario for r in self.rows}):
            rs = [r for r in self.rows if r.scenario == scen]
            out.append({
                "scenario": scen,
                "cells": len(rs),
                "emd_bar": float(np.mean([r.emd_bar for r in rs])),
                "bound_final": float(np.mean([r.bound_final for r in rs])),
                "realized_final": float(np.mean([r.realized_final
                                                 for r in rs])),
                "tightness": float(np.mean([r.tightness for r in rs])),
                "valid_fraction": float(np.mean([r.valid_fraction
                                                 for r in rs])),
            })
        return out

    def to_markdown(self) -> str:
        return per_scenario_markdown(self.per_scenario())

    def to_payload(self) -> Dict[str, object]:
        return {
            "params": self.params,
            "loss_star": self.loss_star,
            "g_n": self.g_n,
            "rows": [dataclasses.asdict(r) for r in self.rows],
            "per_scenario": self.per_scenario(),
            "meta": self.meta,
        }

    def save(self, name: str, directory: str | None = None) -> str:
        return save_artifact(name, "theorem1", self.to_payload(),
                             directory=directory)


# ---------------------------------------------------------------------------
def theorem1_comparison(result: SweepResult,
                        params: Optional[convergence.ConvergenceParams]
                        = None,
                        g_n: float = 0.25,
                        n_ref: int = 8) -> Theorem1Report:
    """Evaluate the Theorem-1 bound against every cell's realized curve.

    `params` supplies the unobservable constants (smoothness, convexity,
    lr, lambda_a); `h` and `theta` are overridden per cell from the sweep.
    `n_ref` is the reference fleet size for the uniform rho_n weights.
    """
    base = params or convergence.ConvergenceParams(eta=0.01, varrho=10.0,
                                                   mu=0.5, lambda_a=0.08)
    loss = result.metrics["loss"]
    # L* proxy strictly below every observed loss (see module docstring)
    spread = float(np.nanmax(loss) - np.nanmin(loss))
    loss_star = float(np.nanmin(loss) - max(0.05 * spread, 1e-3))
    rhos = np.full(n_ref, 1.0 / n_ref)

    rows: List[BoundRow] = []
    for i, cell in enumerate(result.cells):
        T = int(result.rounds[i])
        if T == 0:
            continue
        realized = loss[i, :T] - loss_star
        emd_bar = float(np.nanmean(result.metrics["emd_bar"][i, :T]))
        kappa2 = float(np.nanmean(result.metrics["kappa2"][i, :T]))
        h = int(cell.get("local_steps") or base.h)
        theta = float(max(realized[0], 1e-9))
        p = dataclasses.replace(base, h=h, theta=theta)
        lams = np.full(n_ref, emd_bar * g_n)
        # bound after t = 1..T rounds vs the realized gap at round t-1
        bounds = convergence.bound_curve(p, T, rhos, lams,
                                         1.0 - kappa2, kappa2)[1:]
        realized_f = float(max(realized[-1], 1e-9))
        valid = float(np.mean(bounds + 1e-12 >= realized))
        rows.append(BoundRow(
            index=cell["index"], strategy=cell["strategy"],
            scenario=cell["scenario"], alpha=cell["alpha"],
            seed=cell["seed"], rounds=T, h=h, emd_bar=emd_bar,
            kappa2=kappa2, theta=theta,
            bound_final=float(bounds[-1]), realized_final=realized_f,
            tightness=float(bounds[-1] / realized_f),
            valid_fraction=valid,
            bound_curve=[float(b) for b in bounds],
            realized_curve=[float(r) for r in realized]))

    shared = {k: getattr(base, k)
              for k in ("beta", "varrho", "mu", "eta", "sigma", "lambda_a")}
    meta = {"n_ref": n_ref,
            "planner_dispatches": result.meta.get("planner_dispatches"),
            "planner_batched_fleets":
                result.meta.get("planner_batched_fleets")}
    return Theorem1Report(params=shared, loss_star=loss_star, g_n=g_n,
                          rows=rows, meta=meta)
