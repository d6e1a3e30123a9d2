"""plan_power_ms: SUBP3, the SCA loop (core/planner.py), summed over the
BCD iterations, ms per round: span round/plan/power; nothing where no
round opens it."""
from port_bench.metrics._spans import mean_span_ms


def read(trace):
    return mean_span_ms(trace, ("round/plan/power",))
