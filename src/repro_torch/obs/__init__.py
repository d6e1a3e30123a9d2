"""Structured tracing, metrics and trace export of the port (the JAX
package's `repro.obs`): the span tracer `Obs` and its no-op `NULL_OBS`, the
`MetricsRegistry`, and the JSONL, Perfetto and metrics-artifact sinks.
An enabled tracer only reads values the run already computed and waits for
device work already launched, so traced and untraced runs are bitwise
identical.

`PORT_SPANS` and `PORT_METRICS` are the spans and metrics the port adds
to the JAX package's: it times the planner's subproblems, omega_a and the
fleet step's phases from inside layers that the reference times only from
outside."""
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.sinks import (METRICS_SCHEMA, host_meta,
                                   list_metrics_artifacts,
                                   load_metrics_artifact,
                                   save_metrics_artifact)
from repro_torch.obs.trace import (NULL_OBS, NullObs, Obs, ProgressLogger,
                                   Span, Stopwatch, VirtualClock, log_line,
                                   stopwatch, sync_devices)

#: spans the port opens beyond the JAX package's, all nested in its spans
PORT_SPANS = (
    "round/plan/bandwidth", "round/plan/power", "round/plan/generation",
    "round/plan/ledger", "round/generate/train", "round/aggregate/upload",
    "round/aggregate/sgd", "round/aggregate/eq4")
#: metrics the port feeds beyond the JAX package's
PORT_METRICS = ("planner/steps",)

__all__ = [
    "METRICS_SCHEMA", "MetricsRegistry", "NULL_OBS", "NullObs", "Obs",
    "PORT_METRICS", "PORT_SPANS", "ProgressLogger", "Span", "Stopwatch",
    "VirtualClock", "host_meta",
    "list_metrics_artifacts", "load_metrics_artifact", "log_line",
    "save_metrics_artifact", "stopwatch", "sync_devices",
]
