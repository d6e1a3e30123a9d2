"""Reference-pool DDPM pretraining (paper Sec. III-B), the counterpart of
the JAX package's `gen/pretrain.py`.

The RSU pretrains the class-conditional DDPM once on a small reference pool
(the paper's "AIGC model deployed at the RSU"), then serves every round's
SUBP4 schedule from it. Every draw of the loop comes from
``SeedSequence((seed, lane, PRETRAIN_KEY))``: the initial parameters (lane
0, drawn on the host), the batch indices (lane 1, the JAX package's numpy
stream, so the same batches) and each step's (t, eps) loss draws (lane 2,
on the host). On the CPU any process that pretrains with the same arguments
reconstructs bitwise-identical parameters, so the generator needs no place
in the runner checkpoint; on the card that holds under deterministic cuDNN
(PERF.md). Tests inject the JAX package's initial parameters and loss draws
(`init_params`, `draws`).

Checkpointing (``repro_torch.gen/ddpm-ckpt/v1`` via `checkpoint/io.py`) is
for amortization across processes: `load_pretrained` validates the manifest
fingerprint (ddpm shape + pretrain budget) before restoring.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch.checkpoint.io import read_manifest, restore_tree, save_tree
from repro_torch.data.synthetic import DATASET_CLASSES, make_image_dataset
from repro_torch.diffusion.ddpm import (DDPM, ddpm_loss, draw_loss_noise,
                                        make_ddpm)
from repro_torch.fl.client import images_to_device, labels_to_device
from repro_torch.models.api import resolve_device
from repro_torch.obs import NULL_OBS
from repro_torch.optim import adamw, constant_schedule
from repro_torch.tree import tree_map

DDPM_CKPT_SCHEMA = "repro_torch.gen/ddpm-ckpt/v1"

#: domain tag of the pretraining streams ("PRET"); lanes 0/1/2 split init,
#: batch selection and the loss draws.
PRETRAIN_KEY = 0x50524554


def _pretrain_fingerprint(ddpm: DDPM, dataset: str, steps: int,
                          ref_size: int, batch: int, lr: float,
                          seed: int) -> dict:
    return {"dataset": dataset, "timesteps": ddpm.timesteps,
            "num_classes": ddpm.num_classes, "base_width": ddpm.base_width,
            "beta_min": ddpm.beta_min, "beta_max": ddpm.beta_max,
            "steps": int(steps), "ref_size": int(ref_size),
            "batch": int(batch), "lr": float(lr), "seed": int(seed)}


def _lane(seed: int, lane: int) -> np.random.SeedSequence:
    return np.random.SeedSequence(entropy=(int(seed), lane, PRETRAIN_KEY))


def pretrain_ddpm(ddpm: DDPM, dataset: str = "cifar10", steps: int = 80,
                  ref_size: int = 512, batch: int = 32, lr: float = 2e-4,
                  seed: int = 0, ckpt_path: str | None = None, obs=None,
                  device="cuda", init_params=None,
                  draws: Sequence[Tuple[np.ndarray, np.ndarray]] | None = None
                  ) -> Tuple[dict, list]:
    """Train `ddpm` on a reference pool of `dataset` on `device`; returns
    (params on `device`, per-step losses). If `ckpt_path` is given the
    result is checkpointed there (and a matching existing checkpoint
    short-circuits the loop entirely). `init_params` replaces the initial
    parameters and `draws[s]` = (t [batch], eps [batch, 32, 32, 3]) step
    s's loss draws."""
    if dataset not in DATASET_CLASSES:
        raise ValueError(f"unknown dataset {dataset!r}")
    if DATASET_CLASSES[dataset] != ddpm.num_classes:
        raise ValueError(f"{dataset} has {DATASET_CLASSES[dataset]} classes"
                         f" but ddpm.num_classes={ddpm.num_classes}")
    if draws is not None and len(draws) != steps:
        raise ValueError(f"{len(draws)} loss draws for {steps} steps")
    device = resolve_device(device)
    fp = _pretrain_fingerprint(ddpm, dataset, steps, ref_size, batch, lr,
                               seed)
    if ckpt_path is not None:
        params = _try_restore(ckpt_path, fp, device)
        if params is not None:
            return params, []

    params = init_params if init_params is not None else make_ddpm(
        np.random.Generator(np.random.Philox(_lane(seed, 0))), ddpm, device)
    imgs, labels = make_image_dataset(dataset, ref_size, seed=seed,
                                      noise=0.15)
    x_all = images_to_device(imgs, device)
    y_all = labels_to_device(labels, device)

    opt = adamw(constant_schedule(lr))
    opt_state = opt.init(params)

    def objective(p, x0, y, t, eps):
        return ddpm_loss(p, ddpm, x0, y, t, eps)

    step = grad_and_value(objective)
    rng = np.random.default_rng(_lane(seed, 1))
    loss_rng = np.random.Generator(np.random.Philox(_lane(seed, 2)))
    losses = []
    obs = obs if obs is not None else NULL_OBS
    with obs.span("gen/pretrain", key=(ddpm.base_width, steps),
                  dataset=dataset, steps=steps) as sp:
        for s in range(steps):
            ix = torch.from_numpy(rng.integers(0, len(labels), batch)).to(device)
            t, eps = draws[s] if draws is not None else draw_loss_noise(
                loss_rng, ddpm, batch)
            g, loss = step(params, x_all[ix], y_all[ix],
                           labels_to_device(t, device),
                           images_to_device(eps, device))
            params, opt_state = opt.update(g, opt_state, params)
            losses.append(loss.detach())
        sp.sync = params

    losses = [float(x) for x in torch.stack(losses).cpu()] if losses else []
    if ckpt_path is not None:
        save_tree(ckpt_path, params,
                  metadata={"schema": DDPM_CKPT_SCHEMA, "pretrain": fp,
                            "final_loss": losses[-1] if losses else None})
    return params, losses


def _to_device(tree, device):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(device), tree)


def _try_restore(path: str, fp: dict, device):
    if not path.endswith(".npz"):
        path += ".npz"
    if not os.path.exists(path):
        return None
    meta = read_manifest(path)["metadata"]
    if meta.get("schema") != DDPM_CKPT_SCHEMA or meta.get("pretrain") != fp:
        return None
    return _to_device(restore_tree(path), device)


def load_pretrained(path: str, ddpm: DDPM, device="cuda") -> dict:
    """Restore a ``repro_torch.gen/ddpm-ckpt/v1`` checkpoint onto `device`,
    validating schema and model-shape fingerprint against `ddpm`."""
    if not path.endswith(".npz"):
        path += ".npz"
    meta = read_manifest(path)["metadata"]
    if meta.get("schema") != DDPM_CKPT_SCHEMA:
        raise ValueError(f"not a DDPM checkpoint: schema="
                         f"{meta.get('schema')!r}")
    fp = meta.get("pretrain", {})
    for field in ("timesteps", "num_classes", "base_width"):
        if fp.get(field) != getattr(ddpm, field):
            raise ValueError(f"checkpoint {field}={fp.get(field)} does not "
                             f"match ddpm.{field}={getattr(ddpm, field)}")
    return _to_device(restore_tree(path), resolve_device(device))
