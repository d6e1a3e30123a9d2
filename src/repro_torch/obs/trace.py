"""The disabled tracer (the counterpart of `NullObs` / `NULL_OBS` in the JAX
package's `obs/trace.py`) and the rate-limited progress lines of
`log_line`. The serving engine takes an `obs`, opens a span
around each prefill and decode step, and sets the span's `sync` to the
step's logits, which a tracer may fence or inspect at the span's exit. The
enabled tracer is ported with a later slice."""
from __future__ import annotations

import sys
import time
from typing import Callable, Dict


class _NullSpan:
    """Shared no-op span: `__enter__` returns the singleton, nothing is
    recorded. `sync` writes are swallowed (one slot, never read)."""
    __slots__ = ("sync",)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


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
