"""eval_ms: the evaluation (GenFVRunner.evaluate), ms per round: span
round/eval."""
from port_bench.metrics._spans import mean_span_ms


def read(trace):
    return mean_span_ms(trace, ("round/eval",))
