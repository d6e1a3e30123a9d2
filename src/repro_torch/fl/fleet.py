"""Vectorized fleet execution engine, the counterpart of the JAX package's
`fl/fleet.py`.

All K selected vehicles run their h local-SGD steps (with the FedProx
proximal term when asked) as one `torch.func.vmap` over a leading client
axis, every vehicle starting from the shared global model, and the eq. (4)
aggregation follows over the stacked flat parameter buffers [K, P]
(core/emd.py::aggregate_stacked_guarded, a fixed-order chain). Under vmap
each convolution runs once for all K vehicles, as a grouped convolution.

With `guard=True` (the round loop asks for it when a poisoned batch is in
the step, as the JAX package does) the aggregation rejects the rows of
non-finite updates (fl/faults.py) and falls back to the round-start global
when every row is rejected. With `guard=False` the finite mask is all
true, so a vehicle that diverges on its own reaches the aggregate, as in
the JAX package's unguarded step. Both run the one chain: on finite rows
the guard changes no bit.

Fleet-size bucketing: K is padded up to the power-of-two bucket >= 4 that
the planner shares; padded slots train on all-zero batches (finite work)
and carry zero aggregation weight. Whether the aggregate is bitwise equal
across buckets depends on the device's convolution algorithms; the port's
tests and `chip_smoke.py` pin what holds on the CPU and on the card.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core.emd import aggregate_stacked_guarded, kappas
from repro_torch.core.planner import bucket_size
from repro_torch.fl.client import (images_to_device, labels_to_device,
                                   sgd_steps_flat)
from repro_torch.obs import NULL_OBS
from repro_torch.tree import FlatSpec, tree_leaves


class FleetEngine:
    """Round executor: sample -> pad to bucket -> vmapped local SGD ->
    ordered eq. 4 aggregation. One engine per (model cfg, h, batch size,
    lr)."""

    def __init__(self, cfg_model, local_steps: int, batch_size: int,
                 lr: float):
        self.cfg = cfg_model
        self.h = int(local_steps)
        self.batch_size = int(batch_size)
        self.lr = float(lr)

    # -- host-side batch sampling (mirrors client_update's rng protocol) ---
    def sample_batches(self, rng: np.random.Generator, images, labels):
        """One vehicle's h fixed-shape mini-batches (with replacement)."""
        idx = rng.integers(0, len(labels), size=(self.h, self.batch_size))
        return images[idx], labels[idx]

    # ----------------------------------------------------------------------
    def run(self, global_params, imgs_list: List, labels_list: List,
            rhos: Sequence[float], emd_bar: float = 0.0, aug_params=None,
            prox_mu: float = 0.0, bucket: int | None = None, *,
            guard: bool, obs=NULL_OBS) -> Tuple:
        """Train all K vehicles and aggregate, on the device the global
        parameters lie on.

        imgs_list/labels_list: per-vehicle stacked batches ([h,B,H,W,C] /
        [h,B], numpy); rhos: data weights over the K vehicles; aug_params:
        the RSU-augmented model (None -> plain weighted FedAvg, kappa2 = 0).
        Returns (new global parameter tree, mean loss per vehicle [K],
        finite mask [K]: which vehicles' updates eq. 4 kept, numpy bool;
        all true when `guard` is off). `obs` takes three spans: the host
        stack and the upload, the vmapped SGD (fenced on its output) and
        eq. 4 with the reads of the losses and the mask."""
        k = len(imgs_list)
        if k == 0:
            raise ValueError("FleetEngine.run needs at least one vehicle")
        kb = bucket_size(k) if bucket is None else int(bucket)
        if kb < k:
            raise ValueError(f"bucket {kb} smaller than fleet {k}")

        with obs.span("round/aggregate/upload"):
            imgs = np.stack([np.asarray(x, np.float32) for x in imgs_list])
            labels = np.stack([np.asarray(x, np.int64) for x in labels_list])
            if kb > k:
                imgs = np.pad(imgs,
                              ((0, kb - k),) + ((0, 0),) * (imgs.ndim - 1))
                labels = np.pad(labels,
                                ((0, kb - k),) + ((0, 0),) * (labels.ndim - 1))
            leaf = tree_leaves(global_params)[0]
            imgs = images_to_device(imgs, leaf.device,
                                    leaf.dtype)            # [Kb,h,B,C,H,W]
            labels = labels_to_device(labels, leaf.device)

        with obs.span("round/aggregate/sgd") as sp:
            spec = FlatSpec(global_params)
            flat = spec.flatten(global_params)
            if aug_params is None:
                emd_bar = 0.0          # kappa2 = 0: pure weighted FedAvg
                aug = torch.zeros_like(flat)
            else:
                aug = spec.flatten(aug_params)

            def one_vehicle(bi, bl):
                return sgd_steps_flat(flat, spec, self.cfg, bi, bl, self.h,
                                      self.lr, float(prox_mu))

            stacked, losses = vmap(one_vehicle)(imgs, labels)
            sp.sync = stacked

        with obs.span("round/aggregate/eq4"):
            k1, k2 = kappas(emd_bar)
            weights = np.zeros(kb, np.float32)
            weights[:k] = k1 * np.asarray(rhos, np.float64)
            new_flat, finite = aggregate_stacked_guarded(
                stacked, weights, aug, np.float32(k2), fallback=flat,
                guard=guard)
            return (spec.unflatten(new_flat),
                    losses[:k].cpu().numpy().mean(axis=1),
                    finite[:k].cpu().numpy())
