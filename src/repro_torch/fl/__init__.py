"""Federated round loop of the port: the fleet engine, the RSU server,
fault injection and the synchronous `GenFVRunner` (the JAX package's
`repro.fl`, without streaming)."""
from repro_torch.fl.fleet import FleetEngine
from repro_torch.fl.rounds import (PLANNERS, STRATEGIES, GenFVRunner,
                                   PendingRound, RoundLog, RunConfig,
                                   RunResult, eval_stream_seed, run_payload,
                                   validate_run_fields)
