"""Metrics registry: counters, gauges and distributions with string tags
(a copy of the JAX package's `obs/metrics.py`).

Everything here is host-side bookkeeping over values the pipeline already
computed — recording a metric never launches device work, never draws
randomness, and never forces a sync (spans own the fencing policy). Keys
are ``(name, sorted(tags))`` so the same metric under different tags (e.g.
``span/round/plan{stage=compile}`` vs ``{stage=execute}``) accumulates
separately.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

_Key = Tuple[str, Tuple[Tuple[str, Any], ...]]


def _key(name: str, tags: Dict[str, Any] | None) -> _Key:
    if not tags:
        return (name, ())
    return (name, tuple(sorted(tags.items())))


class MetricsRegistry:
    """Counters (monotonic sums), gauges (last value wins) and
    distributions (n / sum / min / max)."""

    def __init__(self):
        self._counters: Dict[_Key, float] = {}
        self._gauges: Dict[_Key, float] = {}
        self._dists: Dict[_Key, List[float]] = {}   # [n, sum, min, max]

    # ------------------------------------------------------------------
    def count(self, name: str, value: float = 1, **tags) -> None:
        k = _key(name, tags)
        self._counters[k] = self._counters.get(k, 0) + value

    def gauge(self, name: str, value: float, **tags) -> None:
        self._gauges[_key(name, tags)] = value

    def observe(self, name: str, value: float, **tags) -> None:
        k = _key(name, tags)
        d = self._dists.get(k)
        if d is None:
            self._dists[k] = [1, value, value, value]
        else:
            d[0] += 1
            d[1] += value
            d[2] = min(d[2], value)
            d[3] = max(d[3], value)

    # ------------------------------------------------------------------
    def counter_value(self, name: str, **tags) -> float:
        return self._counters.get(_key(name, tags), 0)

    def gauge_value(self, name: str, default: float | None = None,
                    **tags) -> float | None:
        return self._gauges.get(_key(name, tags), default)

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry in (counters add, gauges overwrite,
        distributions pool). Used when aggregating per-process benches."""
        for k, v in other._counters.items():
            self._counters[k] = self._counters.get(k, 0) + v
        self._gauges.update(other._gauges)
        for k, d in other._dists.items():
            mine = self._dists.get(k)
            if mine is None:
                self._dists[k] = list(d)
            else:
                mine[0] += d[0]
                mine[1] += d[1]
                mine[2] = min(mine[2], d[2])
                mine[3] = max(mine[3], d[3])

    # ------------------------------------------------------------------
    @staticmethod
    def _rows(table: Dict[_Key, Any], render) -> List[Dict[str, Any]]:
        rows = []
        for (name, tags) in sorted(table):
            rows.append({"name": name, "tags": dict(tags),
                         **render(table[(name, tags)])})
        return rows

    def payload(self) -> Dict[str, Any]:
        """JSON-ready snapshot (sorted, scalar leaves)."""
        return {
            "counters": self._rows(self._counters,
                                   lambda v: {"value": v}),
            "gauges": self._rows(self._gauges, lambda v: {"value": v}),
            "dists": self._rows(self._dists,
                                lambda d: {"n": d[0], "sum": d[1],
                                           "min": d[2], "max": d[3]}),
        }
