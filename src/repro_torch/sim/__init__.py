"""Persistent vehicular world simulator (a copy of the JAX package's
`repro.sim`).

world       struct-of-arrays VehicularWorld: Poisson arrivals/departures,
            eq.-24 road-load speed feedback, AR(1) log-normal shadowing,
            persistent data-partition binding
scenarios   named traffic presets + registry (RunConfig.scenario)
"""
from repro_torch.sim.scenarios import (LEGACY, SCENARIOS, Scenario,
                                       get_scenario, register,
                                       scenario_names)
from repro_torch.sim.world import VehicularWorld, WorldState, WorldStats
