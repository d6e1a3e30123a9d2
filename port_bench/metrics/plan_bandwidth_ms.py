"""plan_bandwidth_ms: SUBP2, Algorithm 1 with its projection redo
(core/planner.py), summed over the BCD iterations, ms per round: span
round/plan/bandwidth; nothing where no round opens it."""
from port_bench.metrics._spans import mean_span_ms


def read(trace):
    return mean_span_ms(trace, ("round/plan/bandwidth",))
