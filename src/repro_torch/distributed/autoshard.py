"""Logical activation-sharding annotations, the JAX package's
`distributed/autoshard.py` with the same state.

Model code may annotate activations with *logical* axes ("batch",
"model") via `aconstrain`; the launcher activates a mapping to physical
mesh axes around a trace (`activation_sharding`). `active()` and
`logical_size()` read the mapping. In one process `aconstrain` returns
its input unchanged: a layout constraint never changes values (the JAX
package's `with_sharding_constraint` only places them), and on one card
there is no layout to choose. The port's models therefore do not call it
(see the comment in models/moe.py::moe_sorted), and no code of the port
reads the state: the module keeps the JAX API and its semantics for the
caller that a sharded step will bring (tests/test_torch_distributed.py
holds it to the JAX module).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

_STATE = {"batch": None, "model": None, "sizes": {}}


@contextmanager
def activation_sharding(mesh, *, batch_axes: Optional[Tuple[str, ...]] = None,
                        model_axis: str = "model"):
    """Activate logical->physical axis mapping for traces inside the block."""
    names = list(mesh.shape.keys())
    if batch_axes is None:
        batch_axes = tuple(n for n in names if n in ("pod", "data")) or None
    old = dict(_STATE)
    _STATE.update(batch=tuple(batch_axes) if batch_axes else None,
                  model=model_axis if model_axis in names else None,
                  sizes=dict(mesh.shape))
    try:
        yield
    finally:
        _STATE.clear()
        _STATE.update(old)
        _STATE.setdefault("sizes", {})


def _size(ax) -> int:
    sizes = _STATE["sizes"]
    if isinstance(ax, tuple):
        s = 1
        for a in ax:
            s *= sizes.get(a, 1)
        return s
    return sizes.get(ax, 1)


def aconstrain(x, logical: Sequence[Optional[str]]):
    """logical: per-dim 'batch' | 'model' | None. Returns x unchanged (see
    the module docstring)."""
    return x


def active() -> bool:
    return _STATE["batch"] is not None or _STATE["model"] is not None


def logical_size(name: str) -> int:
    """Physical size of a logical axis in the active context (1 if inactive)."""
    ax = _STATE["batch"] if name == "batch" else (
        _STATE["model"] if name == "model" else None)
    return _size(ax) if ax is not None else 1
