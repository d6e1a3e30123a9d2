"""Per-layer metric readers, one file per metric named in BENCHMARK.json:
each has `read(trace) -> float | None`."""
