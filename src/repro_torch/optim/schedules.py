"""Learning-rate schedules of the port (the JAX package's
`optim/schedules.py`): constant, cosine (the default) and WSD
(Warmup-Stable-Decay, MiniCPM's schedule, arXiv:2404.06395 §4).

Each is a function step -> lr as a numpy float32, computed in float32 as
the JAX package computes it: every operand is made float32 before it is
used, so numpy's promotion rules (which differ between numpy 1 and 2 for
Python scalars) never widen a step to float64. Python-scalar products the
JAX code forms before touching an array are formed here the same way.
"""
from __future__ import annotations

import numpy as np

_f = np.float32


def constant_schedule(lr: float):
    def f(step):
        return _f(lr)
    return f


def _clip01(t):
    return min(max(t, _f(0.0)), _f(1.0))


def cosine_schedule(lr: float, total_steps: int, warmup: int = 0,
                    final_frac: float = 0.1):
    def f(step):
        step = _f(step)
        warm = _f(lr) * step / _f(max(warmup, 1))
        t = _clip01((step - _f(warmup)) / _f(max(total_steps - warmup, 1)))
        cos = (_f(final_frac * lr)
               + _f((1 - final_frac) * lr * 0.5) * (_f(1.0) + np.cos(_f(np.pi) * t)))
        return warm if step < warmup else cos
    return f


def wsd_schedule(lr: float, total_steps: int, warmup: int = 0,
                 decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup -> Stable (constant lr) -> Decay (last decay_frac of steps,
    exponential-style anneal to final_frac*lr)."""
    decay_start = int(total_steps * (1 - decay_frac))

    def f(step):
        step = _f(step)
        warm = _f(lr) * step / _f(max(warmup, 1))
        t = _clip01((step - _f(decay_start)) / _f(max(total_steps - decay_start, 1)))
        decay = _f(lr) * np.power(_f(final_frac), t)
        out = _f(lr) if step < decay_start else decay
        return warm if step < warmup else out
    return f


def get_schedule(name: str, lr: float, total_steps: int, warmup: int = 0):
    if name == "wsd":
        return wsd_schedule(lr, total_steps, warmup)
    if name == "cosine":
        return cosine_schedule(lr, total_steps, warmup)
    return constant_schedule(lr)
