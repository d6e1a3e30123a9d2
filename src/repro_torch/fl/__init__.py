"""Federated round loop of the port: the fleet engine, the RSU server and
the synchronous `GenFVRunner` (the JAX package's `repro.fl`, fault-free)."""
from repro_torch.fl.fleet import FleetEngine
from repro_torch.fl.rounds import (PLANNERS, STRATEGIES, GenFVRunner,
                                   PendingRound, RoundLog, RunConfig,
                                   RunResult, eval_stream_seed,
                                   validate_run_fields)
