"""The disabled tracer (the counterpart of `NullObs` / `NULL_OBS` in the JAX
package's `obs/trace.py`). The serving engine takes an `obs`, opens a span
around each prefill and decode step, and sets the span's `sync` to the
step's logits, which a tracer may fence or inspect at the span's exit. The
enabled tracer is ported with a later slice."""
from __future__ import annotations


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
