"""Scenario registry for the persistent vehicular world (repro.sim).

A `Scenario` bundles (a) world-dynamics parameters that live outside
`GenFVConfig` — arrival direction split, AR(1) speed persistence, initial
population, per-vehicle GPU capability ranges — and (b) optional overrides
of the physical-layer fields in `GenFVConfig` (speed law, coverage
geometry, arrival rate, shadowing). `Scenario.apply(cfg)` returns the
overridden config; `VehicularWorld` reads both.

Named presets span the traffic regimes the selection policy has to survive:
free-flow highway, congested rush hour, choppy urban stop-and-go, a
single-direction platoon, and a sparse rural cell. `RunConfig.scenario`
picks one by name; the sentinel name ``"legacy"`` (`LEGACY`) bypasses the
world entirely and keeps the memoryless per-round sampler
(`core/mobility.py::sample_fleet`, whose eq.-24 road load counts the
uncapped Poisson draw).

Register custom scenarios with `register(Scenario(...))`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import GenFVConfig

#: RunConfig.scenario sentinel: the memoryless i.i.d. per-round fleet sampler.
LEGACY = "legacy"

# Scenario fields that override the same-named GenFVConfig fields when set.
_CFG_OVERRIDES = ("v_max", "v_min", "m_max", "sigma_k", "rsu_radius",
                  "rsu_road_offset", "arrival_rate", "shadow_sigma_db",
                  "shadow_corr_time")


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str = ""
    # --- world dynamics (consumed by VehicularWorld directly) -------------
    direction_split: float = 0.5      # P(eastbound) for arrivals
    speed_corr: float = 0.9           # AR(1) rho of individual speed per step
    init_mean: Optional[float] = None  # initial Poisson mean (None -> cfg)
    gpu_f_mem: Tuple[float, float] = (1.25e9, 1.75e9)
    gpu_f_core: Tuple[float, float] = (1.0e9, 1.6e9)
    gpu_v_core: Tuple[float, float] = (0.8, 1.1)
    # --- GenFVConfig overrides (None = keep the config's value) -----------
    v_max: Optional[float] = None
    v_min: Optional[float] = None
    m_max: Optional[int] = None
    sigma_k: Optional[float] = None
    rsu_radius: Optional[float] = None
    rsu_road_offset: Optional[float] = None
    arrival_rate: Optional[float] = None
    shadow_sigma_db: Optional[float] = None
    shadow_corr_time: Optional[float] = None

    def apply(self, cfg: GenFVConfig) -> GenFVConfig:
        """Overlay this scenario's physical-layer overrides onto `cfg`."""
        overrides = {k: getattr(self, k) for k in _CFG_OVERRIDES
                     if getattr(self, k) is not None}
        return dataclasses.replace(cfg, **overrides) if overrides else cfg


SCENARIOS: Dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    """Add a scenario to the registry (name collisions overwrite)."""
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        known = ", ".join(sorted(SCENARIOS))
        raise KeyError(
            f"unknown scenario {name!r}; registered: {known} "
            f"(or {LEGACY!r} for the memoryless seed sampler)") from None


def scenario_names() -> Tuple[str, ...]:
    return tuple(sorted(SCENARIOS))


# ---------------------------------------------------------------------------
# Presets. Geometry defaults to the paper cell (r=500 m chord ~ 1 km) unless
# overridden; arrival rates are picked so the equilibrium population
# (arrival_rate x chord/speed residency) lands in the named regime.
# ---------------------------------------------------------------------------
register(Scenario(
    name="highway_free_flow",
    description="uncongested highway: fast, steady, mild shadowing",
    speed_corr=0.95,
    arrival_rate=1.1, v_max=120.0, v_min=10.0, m_max=160, sigma_k=0.1,
    shadow_sigma_db=3.0, shadow_corr_time=30.0,
))

register(Scenario(
    name="rush_hour",
    description="over-capacity road: eq.-24 congestion collapses speeds; "
                "deep, fast-moving shadowing from dense traffic",
    speed_corr=0.85, init_mean=80.0,
    arrival_rate=3.0, v_max=120.0, v_min=10.0, m_max=60, sigma_k=0.15,
    shadow_sigma_db=6.0, shadow_corr_time=10.0,
))

register(Scenario(
    name="urban_stop_go",
    description="small urban cell: slow choppy speeds, strong short-memory "
                "shadowing from buildings",
    speed_corr=0.5, init_mean=30.0,
    arrival_rate=1.5, v_max=50.0, v_min=5.0, m_max=50, sigma_k=0.35,
    rsu_radius=300.0, rsu_road_offset=15.0,
    shadow_sigma_db=8.0, shadow_corr_time=5.0,
))

register(Scenario(
    name="platoon",
    description="single-direction convoy: tight speed spread, long-memory "
                "channel, everyone exits together",
    direction_split=1.0, speed_corr=0.99, init_mean=25.0,
    arrival_rate=0.8, v_max=100.0, v_min=70.0, m_max=400, sigma_k=0.03,
    shadow_sigma_db=2.0, shadow_corr_time=60.0,
))

register(Scenario(
    name="sparse_rural",
    description="big empty cell: few vehicles, fast, strong slow-fading "
                "shadowing over a long chord",
    speed_corr=0.9, init_mean=8.0,
    arrival_rate=0.15, v_max=110.0, v_min=30.0, m_max=400, sigma_k=0.12,
    rsu_radius=800.0,
    shadow_sigma_db=5.0, shadow_corr_time=40.0,
))
