"""Optimizers of the port as pure functions over parameter trees (the JAX
package's `optim/optimizers.py`); only AdamW is ported so far.

An optimizer is an `Optimizer(init, update)` pair; `update(grads, state,
params)` returns (new_params, new_state) and keeps the step count in the
state. The update is the JAX package's, op for op:

    m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g^2          (float32)
    u = (m/bc1) / (sqrt(v/bc2) + eps) [+ wd*p];  p = p - lr*u

with bc = 1 - b**step in float32. `torch.optim.AdamW` places eps and the
bias corrections differently, so it does not round the same way.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def adamw(schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"step": 0,
                "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
                "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr = float(schedule(state["step"]))
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        # the bias corrections are float32 scalars, as in the JAX package
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return p - (lr * u).to(p.dtype)

        return tree_map(upd, params, m, v), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)
