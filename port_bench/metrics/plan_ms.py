"""plan_ms: the planner (core/planner.py, core/two_scale.py), ms per
round: span round/plan."""
from port_bench.metrics._spans import mean_span_ms


def read(trace):
    return mean_span_ms(trace, ("round/plan",))
