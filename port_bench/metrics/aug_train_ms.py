"""aug_train_ms: omega_a's SGD steps on the generated pool
(fl/server.py::train_augmented), ms per round: span
round/generate/train; nothing where no round opens it."""
from port_bench.metrics._spans import mean_span_ms


def read(trace):
    return mean_span_ms(trace, ("round/generate/train",))
