"""Optimizers of the port as pure functions over parameter trees (the JAX
package's `optim/optimizers.py`): SGD, momentum and AdamW, with the global
gradient norm and its clip.

An optimizer is an `Optimizer(init, update)` pair; `update(grads, state,
params)` returns (new_params, new_state) and keeps the step count in the
state; the learning rate is the schedule's float32 value at that step.
Each update is the JAX package's, op for op:

    sgd:       p = p - lr*g                       (in p's dtype)
    momentum:  m = beta*m + g;  p = p - lr*m      (m in float32)
    adamw:     m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g^2     (float32)
               u = (m/bc1) / (sqrt(v/bc2) + eps) [+ wd*p];  p = p - lr*u

with bc = 1 - b**step in float32. `torch.optim.AdamW` places eps and the
bias corrections differently, so it does not round the same way.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def sgd(schedule) -> Optimizer:
    def init(params):
        return {"step": 0}

    def update(grads, state, params):
        lr = schedule(state["step"])

        def upd(p, g):
            # the float32 lr is cast to p's dtype first, as in the JAX package;
            # a 0-dim CPU tensor enters a CUDA op as a scalar, with no copy
            return p - torch.tensor(lr, dtype=p.dtype) * g.to(p.dtype)

        return tree_map(upd, params, grads), {"step": state["step"] + 1}

    return Optimizer(init, update)


def momentum(schedule, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"step": 0, "m": _zeros_f32(params)}

    def update(grads, state, params):
        lr = float(schedule(state["step"]))
        m = tree_map(lambda m_, g: beta * m_ + g.float(), state["m"], grads)
        new = tree_map(lambda p, m_: p - (lr * m_).to(p.dtype), params, m)
        return new, {"step": state["step"] + 1, "m": m}

    return Optimizer(init, update)


def adamw(schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"step": 0, "m": _zeros_f32(params), "v": _zeros_f32(params)}

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


def make_optimizer(name: str, schedule, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(schedule, **kw)
    if name == "momentum":
        return momentum(schedule, **kw)
    if name == "sgd":
        return sgd(schedule)
    raise ValueError(name)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in the JAX package's tree order, of
    each leaf's float32 sum of squares."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    return torch.sqrt(sum(sq[1:], sq[0]))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)), norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn
