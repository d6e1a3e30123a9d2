"""RSU-side logic: augmented-model training on AIGC data, the fused fleet
round with the EMD-weighted aggregation (paper Sec. III-A step 5, eq. 4),
the sequential path's aggregation and the merge of one late update. The
counterpart of the JAX package's `fl/server.py`."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.core.emd import aggregate, data_weights, kappas, mean_emd
from repro_torch.fl.client import client_update
from repro_torch.obs import NULL_OBS
from repro_torch.tree import FlatSpec


class GenFVServer:
    def __init__(self, cfg_model, global_params, generator, rng):
        self.cfg_model = cfg_model
        self.params = global_params
        self.generator = generator
        self.rng = rng
        self.pool_imgs: np.ndarray | None = None   # accumulated AIGC data
        self.pool_labels: np.ndarray | None = None

    # ---- model augmentation (step 5) -------------------------------------
    def generate(self, label_counts: np.ndarray, round_idx: int = 0):
        labels = np.repeat(np.arange(len(label_counts)), label_counts)
        if len(labels) == 0:
            return 0
        imgs = self.generator.generate(labels, self.rng, round_idx=round_idx)
        if self.pool_imgs is None:
            self.pool_imgs, self.pool_labels = imgs, labels.astype(np.int32)
        else:
            self.pool_imgs = np.concatenate([self.pool_imgs, imgs])
            self.pool_labels = np.concatenate(
                [self.pool_labels, labels.astype(np.int32)])
        return len(labels)

    def train_augmented(self, h: int, batch_size: int, lr: float):
        """omega_a update: h local steps on the generated pool (Sec. III-C1)."""
        if self.pool_imgs is None or len(self.pool_labels) < 2:
            return self.params, 0.0
        return client_update(self.params, self.cfg_model, self.pool_imgs,
                             self.pool_labels, self.rng, h, batch_size, lr)

    # ---- fused vehicle SGD + aggregation (fleet engine path) --------------
    def fleet_round(self, engine, imgs_list: List, labels_list: List,
                    sizes: Sequence[int], emds: Sequence[float],
                    aug_model=None, prox_mu: float = 0.0, *,
                    guard: bool, rhos=None, kappa_emds=None, obs=NULL_OBS):
        """Run all selected vehicles' local SGD and the eq. (4) aggregation
        (fl/fleet.py), finiteness-guarded if `guard`; `self.params` is
        rebound to the aggregate. Returns (params, (kappa1, kappa2),
        losses [K], finite [K]).

        `rhos` overrides the data weights (the round loop computes them
        jointly over fresh and buffered stale participants); `kappa_emds`
        takes the kappa2 EMD pool apart from `emds` for the same reason.
        `obs` takes the fleet step's spans."""
        rhos = data_weights(sizes) if rhos is None \
            else np.asarray(rhos, np.float64)
        emd_bar = mean_emd(emds if kappa_emds is None else kappa_emds) \
            if aug_model is not None else 0.0
        self.params, losses, finite = engine.run(
            self.params, imgs_list, labels_list, rhos, emd_bar, aug_model,
            prox_mu, guard=guard, obs=obs)
        return self.params, kappas(emd_bar), losses, finite

    # ---- merge of one late update -----------------------------------------
    def absorb(self, model, weight: float):
        """Fold one late-arriving update into the global between rounds:
        params <- (1-w)*params + w*model, in float32, `weight` already
        carrying the rho * gamma^age staleness discount."""
        spec = FlatSpec(self.params)
        p = spec.flatten(self.params)
        w = float(weight)
        # each Python weight meets the float32 tensors as a float32 value
        out = (float(np.float32(1.0 - w)) * p.float()
               + float(np.float32(w)) * spec.flatten(model).float())
        self.params = spec.unflatten(out.to(p.dtype))
        return self.params

    # ---- aggregation (eq. 4), sequential path ------------------------------
    def aggregate(self, vehicle_models: List, sizes: Sequence[int],
                  emds: Sequence[float], aug_model=None, *,
                  rhos=None, kappa_emds=None):
        """rhos: the weights of the vehicle models (default
        `data_weights(sizes)`); kappa_emds: the EMDs that set kappa
        (default `emds`)."""
        if not vehicle_models:
            if aug_model is not None:
                self.params = aug_model
            return self.params, (1.0, 0.0)
        rhos = data_weights(sizes) if rhos is None else np.asarray(rhos, np.float64)
        emd_bar = mean_emd(emds if kappa_emds is None else kappa_emds)
        if aug_model is None:
            # FL-only: plain weighted FedAvg (kappa2 = 0)
            aug_model = vehicle_models[0]
            emd_bar = 0.0
        self.params = aggregate(vehicle_models, rhos, aug_model, emd_bar)
        return self.params, kappas(emd_bar)
