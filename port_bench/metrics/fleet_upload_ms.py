"""fleet_upload_ms: the fleet step's host stack and pad of the batches and
their copy to the device (fl/fleet.py), ms per round: span
round/aggregate/upload; nothing where no round opens it."""
from port_bench.metrics._spans import mean_span_ms


def read(trace):
    return mean_span_ms(trace, ("round/aggregate/upload",))
