"""host_ms: the host layer (sim/, core/selection.py, the batch sampling
of fl/fleet.py), ms per round: spans round/fleet + round/select +
round/local_sgd + round/world_step."""
from port_bench.metrics._spans import mean_span_ms


def read(trace):
    return mean_span_ms(trace, ("round/fleet", "round/select", "round/local_sgd",
                                "round/world_step"))
