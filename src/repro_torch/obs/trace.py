"""Span/event tracer with an explicit clock, the counterpart of the JAX
package's `obs/trace.py`.

`Obs` is the enabled tracer; `NULL_OBS` is the shared no-op object every
component holds by default. The two expose the same surface, so call sites
are unconditional, and the disabled path allocates nothing beyond the calls
themselves.

Two timing policies, both opt-in per span:

* **Boundary fencing** — CUDA work is asynchronous: the host returns before
  the device finishes. A span whose `sync` attribute is set (a tensor or a
  tree of tensors) synchronises the CUDA devices those tensors lie on at
  span EXIT only, so the fence lands on a span boundary. Nothing is synced
  for tensors on the CPU, and `NullObs` never syncs. Waiting for work
  already launched changes no value: enabled and disabled runs are bitwise
  identical.
* **First-call tagging** — the first time a (name, key) pair is seen by
  this tracer the span is tagged ``stage="compile"``, later calls
  ``stage="execute"``. `key` is the JAX package's compile-cache key (the
  fleet bucket, the planner bucket, whether poison is in the fleet step),
  so the first call of each carries the one-time costs (cuDNN's algorithm
  choice, allocator growth) the JAX package's tag carries its compiles.

`log_line` renders rate-limited progress lines and, with an enabled
tracer, records them as events.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.tree import tree_leaves

__all__ = ["NULL_OBS", "NullObs", "Obs", "ProgressLogger", "Span",
           "Stopwatch", "VirtualClock", "log_line", "stopwatch",
           "sync_devices"]


# ---------------------------------------------------------------------------
# Deterministic virtual wall-clock.
# ---------------------------------------------------------------------------
class VirtualClock:
    """An explicitly-advanced time source: calling it reads the current
    virtual time, `advance(dt)` moves it forward. Drop-in for the `clock`
    parameter of `Obs`/`Stopwatch`."""
    __slots__ = ("t",)

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0.0:
            raise ValueError(f"virtual clock cannot run backwards (dt={dt})")
        self.t += float(dt)
        return self.t


class Stopwatch:
    """``with stopwatch() as sw: ...; sw.elapsed_s`` — explicit-clock
    wall timer. `elapsed_s` is live while the block runs and frozen at
    exit."""
    __slots__ = ("_clock", "t0", "_final")

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self.t0 = clock()
        self._final: Optional[float] = None

    @property
    def elapsed_s(self) -> float:
        return self._final if self._final is not None \
            else self._clock() - self.t0

    def __enter__(self) -> "Stopwatch":
        self.t0 = self._clock()
        self._final = None
        return self

    def __exit__(self, *exc) -> bool:
        self._final = self._clock() - self.t0
        return False


def stopwatch(clock: Callable[[], float] = time.perf_counter) -> Stopwatch:
    return Stopwatch(clock)


def sync_devices(tree) -> None:
    """Wait for the work that produces the tensors of `tree` (a tensor or
    nested dicts, lists and tuples of them; other leaves are ignored):
    synchronise each CUDA device they lie on, once. Tensors on the CPU
    need no wait."""
    seen = set()
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor) and x.device.type == "cuda" \
                and x.device not in seen:
            seen.add(x.device)
            torch.cuda.synchronize(x.device)


# ---------------------------------------------------------------------------
# Spans.
# ---------------------------------------------------------------------------
class Span:
    """One timed region. Produced by `Obs.span`; set `sync` inside the
    block to the tensors the region produces, to fence them at the span's
    exit."""
    __slots__ = ("_obs", "name", "key", "tags", "t0", "sync")

    def __init__(self, obs: "Obs", name: str, key, tags: Dict[str, Any]):
        self._obs = obs
        self.name = name
        self.key = key
        self.tags = tags
        self.sync = None
        self.t0 = 0.0

    def __enter__(self) -> "Span":
        self._obs._open.append(self.name)
        self.t0 = self._obs._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.sync is not None:
            sync_devices(self.sync)
        self._obs._close_span(self)
        return False


class _NullSpan:
    """Shared no-op span: `__enter__` returns the singleton, nothing is
    recorded. `sync` writes are swallowed (one slot, never read)."""
    __slots__ = ("sync",)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


# ---------------------------------------------------------------------------
# The tracer.
# ---------------------------------------------------------------------------
class Obs:
    """Enabled tracer + metrics registry.

    clock: explicit time source (seconds, monotonic); injectable so tests
        can drive deterministic timestamps.
    meta: free-form run identification folded into every sink payload.
    """
    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 meta: Dict[str, Any] | None = None):
        from repro_torch.obs.metrics import MetricsRegistry
        self._clock = clock
        self._t0 = clock()
        self.meta = dict(meta or {})
        self.events: List[Dict[str, Any]] = []
        self.metrics = MetricsRegistry()
        self._open: List[str] = []
        self._seen: set = set()

    # -- spans / events ----------------------------------------------------
    def span(self, name: str, key=None, **tags) -> Span:
        return Span(self, name, key, tags)

    def _close_span(self, sp: Span) -> None:
        end = self._clock()
        self._open.pop()
        seen_key = (sp.name, sp.key)
        if seen_key in self._seen:
            stage = "execute"
        else:
            self._seen.add(seen_key)
            stage = "compile" if sp.key is not None else "execute"
        dur = end - sp.t0
        self.events.append({"ph": "X", "name": sp.name,
                            "ts": sp.t0 - self._t0, "dur": dur,
                            "stage": stage, "tags": sp.tags})
        self.metrics.observe(f"span/{sp.name}", dur, stage=stage)

    def event(self, name: str, **tags) -> None:
        self.events.append({"ph": "i", "name": name,
                            "ts": self._clock() - self._t0, "tags": tags})

    @property
    def open_spans(self) -> int:
        return len(self._open)

    # -- metrics (delegation) ----------------------------------------------
    def count(self, name: str, value: float = 1, **tags) -> None:
        self.metrics.count(name, value, **tags)

    def gauge(self, name: str, value: float, **tags) -> None:
        self.metrics.gauge(name, value, **tags)

    def observe(self, name: str, value: float, **tags) -> None:
        self.metrics.observe(name, value, **tags)

    # -- scoping -----------------------------------------------------------
    def tagged(self, **tags) -> "_Tagged":
        """A view of this tracer that adds `tags` to every span/event/metric
        (e.g. ``obs.tagged(cell=3)`` for one cell's runner)."""
        return _Tagged(self, tags)

    # -- sinks (obs/sinks.py) ----------------------------------------------
    def metrics_payload(self, name: str = "run") -> Dict[str, Any]:
        from repro_torch.obs.sinks import metrics_payload
        return metrics_payload(self, name)

    def save_metrics(self, name: str, directory: str | None = None) -> str:
        from repro_torch.obs.sinks import save_metrics_artifact
        return save_metrics_artifact(self.metrics_payload(name), name,
                                     directory=directory)

    def write_trace(self, path: str) -> str:
        from repro_torch.obs.sinks import write_trace
        return write_trace(self, path)

    def write_jsonl(self, path: str) -> str:
        from repro_torch.obs.sinks import write_jsonl
        return write_jsonl(self, path)


class _Tagged:
    """Tag-scoped view of an `Obs` (same surface, extra tags merged in)."""
    __slots__ = ("_obs", "_tags")
    enabled = True

    def __init__(self, obs: Obs, tags: Dict[str, Any]):
        self._obs = obs
        self._tags = tags

    def span(self, name: str, key=None, **tags) -> Span:
        return self._obs.span(name, key=key, **{**self._tags, **tags})

    def event(self, name: str, **tags) -> None:
        self._obs.event(name, **{**self._tags, **tags})

    def count(self, name: str, value: float = 1, **tags) -> None:
        self._obs.count(name, value, **{**self._tags, **tags})

    def gauge(self, name: str, value: float, **tags) -> None:
        self._obs.gauge(name, value, **{**self._tags, **tags})

    def observe(self, name: str, value: float, **tags) -> None:
        self._obs.observe(name, value, **{**self._tags, **tags})

    def tagged(self, **tags) -> "_Tagged":
        return _Tagged(self._obs, {**self._tags, **tags})


class NullObs:
    """The disabled path: every method is a no-op, `span` hands back one
    shared context manager. No state, no allocation, no device work."""
    enabled = False
    __slots__ = ()

    def span(self, name, key=None, **tags):
        return _NULL_SPAN

    def event(self, name, **tags):
        pass

    def count(self, name, value=1, **tags):
        pass

    def gauge(self, name, value, **tags):
        pass

    def observe(self, name, value, **tags):
        pass

    def tagged(self, **tags):
        return self


NULL_OBS = NullObs()


# ---------------------------------------------------------------------------
# Rate-limited human-readable progress.
# ---------------------------------------------------------------------------
class ProgressLogger:
    """Per-key rate limiter over a render stream. A key's line is written
    at most once per `min_interval_s` (wall clock), except `force=True`
    (final-round summaries always land)."""

    def __init__(self, min_interval_s: float = 0.1,
                 clock: Callable[[], float] = time.monotonic, out=None):
        self.min_interval_s = min_interval_s
        self._clock = clock
        self._out = out
        self._last: Dict[str, float] = {}

    def emit(self, key: str, text: str, force: bool = False) -> bool:
        now = self._clock()
        last = self._last.get(key)
        if not force and last is not None \
                and now - last < self.min_interval_s:
            return False
        self._last[key] = now
        out = self._out if self._out is not None else sys.stdout
        out.write(text + "\n")
        return True


_PROGRESS = ProgressLogger()


def log_line(obs, key: str, text: str, force: bool = False,
             **fields) -> None:
    """Structured progress logging: record a `log` event on `obs` (when
    enabled) and render the human-readable line through the shared
    rate-limited ProgressLogger. The rendering side exists even when obs
    is disabled — `verbose=True` callers still see their lines."""
    if obs is not None and obs.enabled:
        obs.event("log", key=key, text=text, **fields)
    _PROGRESS.emit(key, text, force=force)
