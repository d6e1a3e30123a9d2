"""Vehicle-side local training (paper Sec. III-C1): h mini-batch SGD steps
from the distributed global model, and the FedProx proximal variant [18].
The counterpart of the JAX package's `fl/client.py`.

The steps run over one flat parameter buffer (`tree.FlatSpec`,
leaves in the JAX tree order): one gradient and one update per step over the
whole model. `sgd_steps_flat` is the body the fleet engine (fl/fleet.py)
vmaps over the vehicles; `local_sgd_steps` runs it on one parameter tree.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch.models.cnn import cnn_loss
from repro_torch.tree import FlatSpec, tree_leaves


def images_to_device(images: np.ndarray, device,
                     dtype=torch.float32) -> torch.Tensor:
    """[..., H, W, C] numpy images -> [..., C, H, W] on `device` in `dtype`
    (the parameters' dtype): the one layout change at the device boundary."""
    t = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device)
    return t.movedim(-1, -3).to(dtype).contiguous()


def labels_to_device(labels: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(labels, np.int64)).to(device)


def sgd_steps_flat(flat: torch.Tensor, spec: FlatSpec, cfg, imgs, labels,
                   h: int, lr: float, prox_mu: float = 0.0):
    """h SGD steps from `flat` [P] over stacked batches (imgs [h,B,C,H,W],
    labels [h,B]); returns (flat [P], losses [h]).

    The loss is the batch's mean cross-entropy in fp32; prox_mu > 0 adds
    FedProx's 0.5 * mu * ||w - w_global||^2, anchored at the incoming
    `flat`, summed leaf by leaf in the JAX tree order."""
    anchor = spec.unflatten(flat)

    def objective(w, x, y):
        p = spec.unflatten(w)
        loss = cnn_loss(p, cfg, x, y)[0]
        if prox_mu > 0.0:
            sq = sum(torch.sum(torch.square(a - b)) for a, b in
                     zip(tree_leaves(p), tree_leaves(anchor)))
            loss = loss + 0.5 * prox_mu * sq
        return loss

    step = grad_and_value(objective)
    losses = []
    for i in range(h):
        g, loss = step(flat, imgs[i], labels[i])
        flat = flat - lr * g
        losses.append(loss)
    return flat, torch.stack(losses)


def local_sgd_steps(params, cfg, imgs, labels, h: int, lr: float,
                    prox_mu: float = 0.0):
    """`sgd_steps_flat` on a parameter tree: returns (tree, losses [h])."""
    spec = FlatSpec(params)
    flat, losses = sgd_steps_flat(spec.flatten(params), spec, cfg, imgs,
                                  labels, h, lr, prox_mu)
    return spec.unflatten(flat), losses


def client_update(params, cfg, images, labels, rng: np.random.Generator,
                  h: int, batch_size: int, lr: float, prox_mu: float = 0.0):
    """Sample h local mini-batches (with replacement, the JAX package's
    `rng.integers(0, n, size=(h, B))` draw) and run local SGD on the device
    the parameters lie on. Returns (params, mean loss)."""
    leaf = tree_leaves(params)[0]
    idx = rng.integers(0, len(labels), size=(h, batch_size))
    new_params, losses = local_sgd_steps(
        params, cfg, images_to_device(images[idx], leaf.device, leaf.dtype),
        labels_to_device(labels[idx], leaf.device), h, lr, prox_mu)
    return new_params, float(losses.mean())
