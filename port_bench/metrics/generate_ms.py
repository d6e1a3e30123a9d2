"""generate_ms: generation and omega_a (fl/generator.py, fl/server.py),
ms per round: span round/generate; nothing where the strategy generates
nothing."""
from port_bench.metrics._spans import mean_span_ms


def read(trace):
    return mean_span_ms(trace, ("round/generate",))
