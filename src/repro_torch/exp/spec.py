"""Declarative experiment grids, the counterpart of the JAX package's
`exp/spec.py` under the port's schema prefix (`exp/artifacts.py`).

An `ExperimentSpec` names the sweep axes the paper's results actually
vary — strategy, scenario, Dirichlet alpha, seed, and the AIGC sampler's
step count (the SUBP4 quality/cost dial) — plus an override-variant
axis for anything else on `RunConfig` (planner backend, model size, ...).
`expand()` returns one frozen, registry-validated `RunConfig` per grid cell
in a deterministic order; validation runs eagerly at spec construction, so
a typo'd strategy name fails before any dataset is built or kernel traced.

`to_json()` is byte-deterministic across processes (sorted keys, plain
scalars only; tests/test_torch_genfv_exp.py pins it).

Planner names are the port's (`fl/rounds.py::PLANNERS`: "torch",
"numpy"). A payload of the JAX package that names planner "jax" is refused
by `RunConfig`'s validation, with an error that names "torch": mapping it
silently would record a planner that never ran.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.exp.artifacts import schema_tag
from repro_torch.fl.rounds import RunConfig, run_payload

SPEC_SCHEMA = schema_tag("spec")                  # repro_torch.exp/spec/v1

#: RunConfig fields owned by the grid axes — overriding them per-variant
#: would make a cell's coordinates ambiguous.
_AXIS_FIELDS = frozenset({"strategy", "scenario", "alpha", "seed",
                          "sampler_steps"})
#: "obs" is execution machinery (attach a tracer via Sweep(obs=...) or the
#: runner, not through a serialized spec): not a valid override.
_RUN_FIELDS = frozenset(
    f.name for f in dataclasses.fields(RunConfig)) - {"obs"}


def grid(**axes: Sequence) -> List[Dict[str, Any]]:
    """Ordered cartesian product of named axes.

    ``grid(dataset=("cifar10", "gtsrb"), alpha=(0.1, 1.0))`` yields the four
    dicts in nested order (later axes fastest). Deterministic: iteration
    follows keyword order, never hash order. The light-weight counterpart of
    `ExperimentSpec.expand()` for parameter loops that do not run FL rounds
    (the paper's Figs. 5 and 9).
    """
    cells: List[Dict[str, Any]] = [{}]
    for key, values in axes.items():
        cells = [dict(c, **{key: v}) for c in cells for v in values]
    return cells


def _freeze_overrides(overrides) -> Tuple[Tuple[Tuple[str, Any], ...], ...]:
    """Normalize a sequence of override dicts into hashable sorted tuples."""
    frozen = []
    for ov in (overrides if overrides else ({},)):
        items = sorted(dict(ov).items())
        for key, _ in items:
            if key in _AXIS_FIELDS:
                raise ValueError(
                    f"override {key!r} collides with a grid axis; sweep it "
                    f"via the {key}s axis instead")
            if key not in _RUN_FIELDS:
                raise ValueError(
                    f"unknown RunConfig field {key!r} in overrides; valid: "
                    f"{', '.join(sorted(_RUN_FIELDS))}")
        frozen.append(tuple(items))
    return tuple(frozen)


@dataclass(frozen=True)
class Cell:
    """One grid point: its coordinates plus the frozen RunConfig."""
    index: int
    strategy: str
    scenario: str
    alpha: float
    seed: int
    sampler_steps: int
    variant: int                       # index into spec.overrides
    run: RunConfig

    def coords(self) -> Dict[str, Any]:
        return {"index": self.index, "strategy": self.strategy,
                "scenario": self.scenario, "alpha": self.alpha,
                "seed": self.seed, "sampler_steps": self.sampler_steps,
                "variant": self.variant}


@dataclass(frozen=True)
class ExperimentSpec:
    name: str = "experiment"
    #: axes left as None inherit a single value from `base` — so a spec
    #: never silently discards e.g. base.seed just because the seed axis
    #: was not swept
    strategies: Tuple[str, ...] | None = None
    scenarios: Tuple[str, ...] | None = None
    alphas: Tuple[float, ...] | None = None
    seeds: Tuple[int, ...] | None = None
    #: AIGC sampler stride (RunConfig.sampler_steps): the quality/cost dial
    #: of the diffusion dataplane. Inherits (base.sampler_steps,) like the
    #: other axes, so oracle-only specs are unaffected.
    sampler_steps: Tuple[int, ...] | None = None
    #: non-axis RunConfig fields shared by every cell (rounds, sizes, ...)
    base: RunConfig = field(default_factory=RunConfig)
    #: per-variant RunConfig overrides; accepts dicts, stored as sorted
    #: (key, value) tuples so the spec stays hashable. One empty variant
    #: by default (the base config itself).
    overrides: Tuple = ((),)

    def __post_init__(self):
        b = self.base
        axes = {"strategies": (b.strategy,), "scenarios": (b.scenario,),
                "alphas": (b.alpha,), "seeds": (b.seed,),
                "sampler_steps": (b.sampler_steps,)}
        for axis, fallback in axes.items():
            if getattr(self, axis) is None:
                object.__setattr__(self, axis, fallback)
        object.__setattr__(self, "strategies", tuple(self.strategies))
        object.__setattr__(self, "scenarios", tuple(self.scenarios))
        object.__setattr__(self, "alphas",
                           tuple(float(a) for a in self.alphas))
        object.__setattr__(self, "seeds", tuple(int(s) for s in self.seeds))
        object.__setattr__(self, "sampler_steps",
                           tuple(int(s) for s in self.sampler_steps))
        object.__setattr__(self, "overrides",
                           _freeze_overrides(self.overrides))
        for axis in ("strategies", "scenarios", "alphas", "seeds",
                     "sampler_steps"):
            if not getattr(self, axis):
                raise ValueError(f"axis {axis} is empty")
        # eager validation: constructing every cell runs RunConfig's
        # registry checks, so bad strategy/scenario/planner names fail
        # here — not ten minutes into a sweep
        self.expand()

    # ------------------------------------------------------------------
    @property
    def n_cells(self) -> int:
        return (len(self.strategies) * len(self.scenarios)
                * len(self.alphas) * len(self.seeds)
                * len(self.sampler_steps) * len(self.overrides))

    def expand(self) -> List[Cell]:
        """Deterministic nested expansion: strategy (slowest) > scenario >
        alpha > seed > sampler_steps > override variant (fastest)."""
        cells: List[Cell] = []
        i = 0
        for strat in self.strategies:
            for scen in self.scenarios:
                for alpha in self.alphas:
                    for seed in self.seeds:
                        for steps in self.sampler_steps:
                            for v, ov in enumerate(self.overrides):
                                run = dataclasses.replace(
                                    self.base, strategy=strat, scenario=scen,
                                    alpha=alpha, seed=seed,
                                    sampler_steps=steps, **dict(ov))
                                cells.append(Cell(i, strat, scen, alpha,
                                                  seed, steps, v, run))
                                i += 1
        return cells

    # ------------------------------------------------------------------
    def to_payload(self) -> Dict[str, Any]:
        return {
            "schema": SPEC_SCHEMA,
            "name": self.name,
            "axes": {
                "strategies": list(self.strategies),
                "scenarios": list(self.scenarios),
                "alphas": list(self.alphas),
                "seeds": list(self.seeds),
                "sampler_steps": list(self.sampler_steps),
            },
            "base": run_payload(self.base),
            "overrides": [dict(ov) for ov in self.overrides],
        }

    def to_json(self) -> str:
        """Canonical serialization: byte-identical for equal specs across
        fresh processes (sorted keys, fixed separators, scalar leaves)."""
        return json.dumps(self.to_payload(), sort_keys=True,
                          separators=(",", ":"), allow_nan=False)

    @classmethod
    def from_payload(cls, payload: Dict[str, Any]) -> "ExperimentSpec":
        if payload.get("schema") != SPEC_SCHEMA:
            raise ValueError(f"not an {SPEC_SCHEMA} payload: "
                             f"{payload.get('schema')!r}")
        axes = payload["axes"]
        return cls(name=payload["name"],
                   strategies=tuple(axes["strategies"]),
                   scenarios=tuple(axes["scenarios"]),
                   alphas=tuple(axes["alphas"]),
                   seeds=tuple(axes["seeds"]),
                   # absent in pre-axis artifacts: inherit from base
                   sampler_steps=(tuple(axes["sampler_steps"])
                                  if axes.get("sampler_steps") is not None
                                  else None),
                   base=RunConfig(**payload["base"]),
                   overrides=tuple(payload["overrides"]))

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_payload(json.loads(text))
