"""Shared by the per-layer readers: the mean per round of span times over
the traced window's rounds that ran outside the profiler."""


def timed_rounds(trace: dict) -> list:
    return [r for r in trace["rounds"] if r["ms"] is not None and not r["profiled"]]


def mean_span_ms(trace: dict, names) -> float | None:
    rounds = [r for r in timed_rounds(trace) if any(n in r["ms"] for n in names)]
    if not rounds:
        return None
    return sum(sum(r["ms"].get(n, 0.0) for n in names) for r in rounds) / len(rounds)
