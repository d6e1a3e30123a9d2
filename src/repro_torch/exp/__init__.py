"""The port's experiment layer (the JAX package's `repro.exp`): the API for
the paper's sweep-shaped results (Figs. 5-10, Theorem 1).

spec       ExperimentSpec: a declarative grid over strategy x scenario x
           alpha x seed x sampler_steps x config-override variants;
           `expand()` freezes one validated RunConfig per cell. `grid()` is
           the bare ordered cartesian product.
sweep      Sweep: runs a spec in round-lockstep on one device, sharing
           dataset builds and FleetEngines across cells and planning the
           torch-planner cells of a round in batched `plan_rounds_batched`
           calls. Returns a struct-of-arrays SweepResult.
analysis   Theorem 1 as an API call: the convergence bound per cell against
           its realized loss curve, aggregated per scenario.
artifacts  versioned JSON artifact store (default: artifacts/), under the
           schema prefix `repro_torch.exp`.
"""
from repro_torch.exp.analysis import (BoundRow, Theorem1Report,
                                      optimal_kappa2, per_scenario_markdown,
                                      theorem1_comparison)
from repro_torch.exp.artifacts import (artifact_dir, list_artifacts,
                                       load_artifact, save_artifact,
                                       schema_tag)
from repro_torch.exp.spec import SPEC_SCHEMA, Cell, ExperimentSpec, grid
from repro_torch.exp.sweep import SWEEP_SCHEMA, Sweep, SweepResult

__all__ = [
    "Cell", "ExperimentSpec", "grid", "SPEC_SCHEMA",
    "Sweep", "SweepResult", "SWEEP_SCHEMA",
    "BoundRow", "Theorem1Report", "theorem1_comparison", "optimal_kappa2",
    "per_scenario_markdown",
    "artifact_dir", "save_artifact", "load_artifact", "list_artifacts",
    "schema_tag",
]
