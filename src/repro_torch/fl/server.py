"""RSU-side logic: augmented-model training on AIGC data and the fused
fleet round with the EMD-weighted aggregation (paper Sec. III-A step 5,
eq. 4). The counterpart of the JAX package's `fl/server.py`, fault-free
path: the guarded aggregation, `absorb` and the sequential `aggregate` are
not ported yet."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.core.emd import data_weights, kappas, mean_emd
from repro_torch.fl.client import client_update


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
                    aug_model=None, prox_mu: float = 0.0):
        """Run all selected vehicles' local SGD and the eq. (4) aggregation
        (fl/fleet.py); `self.params` is rebound to the aggregate."""
        rhos = data_weights(sizes)
        emd_bar = mean_emd(emds) if aug_model is not None else 0.0
        self.params, losses = engine.run(self.params, imgs_list, labels_list,
                                         rhos, emd_bar, aug_model, prox_mu)
        return self.params, kappas(emd_bar), losses
