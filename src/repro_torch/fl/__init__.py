"""Federated round loop of the port (the JAX package's `repro.fl`): the
fleet engine, the RSU server, fault injection, the synchronous
`GenFVRunner` and the event-driven `StreamEngine`."""
from repro_torch.fl.faults import (FaultInjector, FaultSpec, RoundFaults,
                                   StaleBuffer, StaleEntry, fault_names,
                                   get_fault, register_fault)
from repro_torch.fl.fleet import FleetEngine
from repro_torch.fl.rounds import (PLANNERS, STRATEGIES, GenFVRunner,
                                   PendingRound, RoundLog, RunConfig,
                                   RunResult, eval_stream_seed, run_payload,
                                   validate_run_fields)
from repro_torch.fl.stream import InFlight, StreamEngine, StreamLog
