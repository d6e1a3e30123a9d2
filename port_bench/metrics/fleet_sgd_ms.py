"""fleet_sgd_ms: the fleet step's vmapped SGD (fl/fleet.py), ms per round:
span round/aggregate/sgd; nothing where no round opens it."""
from port_bench.metrics._spans import mean_span_ms


def read(trace):
    return mean_span_ms(trace, ("round/aggregate/sgd",))
