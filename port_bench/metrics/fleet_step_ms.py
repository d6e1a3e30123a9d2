"""fleet_step_ms: the fleet step (fl/fleet.py, core/emd.py,
models/cnn.py), ms per round: span round/aggregate."""
from port_bench.metrics._spans import mean_span_ms


def read(trace):
    return mean_span_ms(trace, ("round/aggregate",))
