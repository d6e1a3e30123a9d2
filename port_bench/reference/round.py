"""One GenFV round in the reference (paper Fig. 2 and Algorithm 3), from
the state the round starts in.

What a round takes from outside: the world's view of the fleet (the
vehicles' positions, speeds, radios, GPUs and data partitions), b_prev, the
global parameters it starts from, and the state of the round's random
stream where the program's round starts drawing (selection, generation and
batches). The reference redoes from there: SUBP1 and SUBP2-4, which
vehicles stay in coverage, the generated images (through the generator
reference the caller hands it), omega_a's 16 SGD steps, each vehicle's 4,
and eq. 4.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from port_bench.reference import model as M
from port_bench.reference import solvers as S


@dataclass
class Partitions:
    """The clients' data as the reference derives it: the Dirichlet
    partition of the train labels, its histograms, EMDs and sizes."""
    images: np.ndarray
    labels: np.ndarray
    parts: list
    emds: list = field(default_factory=list)
    sizes: list = field(default_factory=list)

    @classmethod
    def build(cls, images, labels, classes: int, n_clients: int, alpha: float,
              world_seed: int):
        from port_bench.reference.data import dirichlet_partition, emd
        parts = dirichlet_partition(labels, n_clients, alpha,
                                    np.random.default_rng(world_seed))
        hists = [np.bincount(labels[ix], minlength=classes) / max(len(ix), 1)
                 for ix in parts]
        return cls(images, labels, parts, [emd(h) for h in hists],
                   [len(ix) for ix in parts])


def vehicles(world_fleet, world_parts, data: Partitions) -> list:
    """The fleet as the planner sees it: the world's state of each vehicle
    with the EMD and size of the partition it holds."""
    out = []
    for v, p in zip(world_fleet, world_parts):
        d = dict(v)
        d["emd"], d["data_size"] = data.emds[int(p)], data.sizes[int(p)]
        out.append(d)
    return out


def to_device(images: np.ndarray, device) -> torch.Tensor:
    """[..., H, W, C] numpy -> [..., C, H, W] float32 on `device`."""
    return torch.from_numpy(np.ascontiguousarray(images)).to(device).movedim(-1, -3).contiguous()


def eq4(p0, models: list, rho, kappa: tuple, aug):
    """Eq. 4: kappa1 * sum_n rho_n omega_n + kappa2 * omega_a, in float64,
    stored in float32. With no vehicle model the round keeps omega_a (or
    the round-start model where there is none)."""
    if not models:
        return aug if aug is not None else p0
    k1, k2 = kappa
    model_leaves = [M.leaves(m) for m in models]
    aug_leaves = M.leaves(aug) if aug is not None else None
    vals = []
    with torch.no_grad():
        for i in range(len(model_leaves[0])):
            out = k1 * sum(float(r) * ls[i].double() for r, ls in zip(rho, model_leaves))
            if aug_leaves is not None:
                out = out + k2 * aug_leaves[i].double()
            vals.append(out.float())
    return M.rebuild(p0, vals)


def _plan(cell: dict, state: dict, data: Partitions, model_bits: float, ft):
    c, h = cell["c"], cell["local_steps"]
    fleet = vehicles(state["fleet"], state["parts"], data)
    if cell["strategy"] == "genfv":
        alpha = S.select_genfv(c, fleet, model_bits, h, ft)
    else:
        rng = np.random.default_rng()
        rng.bit_generator.state = state["rng_select"]
        alpha = S.select_random(rng, len(fleet), cell["select_fraction"])
    return fleet, S.plan(c, fleet, alpha, model_bits, h, state["b_prev"], ft)


def model_bits(model: dict) -> float:
    """32 bits a parameter of the configuration's model."""
    return 32.0 * M.count_params(model)


def plan_only(cell: dict, state: dict, data: Partitions, ft=np.float64) -> dict:
    """SUBP1 and SUBP2-4 of one round."""
    return _plan(cell, state, data, model_bits(cell["model"]), ft)[1]


def run_round(cell: dict, state: dict, data: Partitions, pool: tuple, p0,
              prec: M.Precision = M.FP32, ft=np.float64, *, generate,
              half_batch=()) -> dict:
    """The reference's round. `cell` holds the constants ("c"), the model
    dict ("model"), the dataset name, classes, strategy, h, B, the RSU's
    step factor and the client learning rate. `state` holds "fleet" (list
    of vehicle dicts), "parts", "b_prev", "rng_select" and "rng_train" (bit
    generator states). `pool` is the generated pool (images, labels) before
    the round. `half_batch` names the planted fault of the check's
    readings: the SGD steps of omega_a ("aug") or of the vehicles
    ("vehicles") see the first half of each batch. `generate(labels, rng)`
    gives the round's images, drawing from `rng` where the generator draws
    from the round's stream; it runs under `prec`. Returns the plan,
    omega_a (None without generation) and the mean of its step losses, the
    vehicles' models, their weights rho, (kappa1, kappa2), the mean of the
    vehicles' step losses, the new global tree ("new") and the pool after."""
    c = cell["c"]
    h, B, lr = cell["local_steps"], cell["batch_size"], cell["client_lr"]
    device = p0["head"]["w"].device
    fleet, plan = _plan(cell, state, data, model_bits(cell["model"]), ft)

    rng = np.random.default_rng()
    rng.bit_generator.state = state["rng_train"]
    pool_x, pool_y = pool
    aug = aug_loss = None
    with prec.active(device):
        if cell["strategy"] == "genfv":
            labels = np.repeat(np.arange(cell["classes"]),
                               S.label_schedule(plan["b_gen"], cell["classes"]))
            if len(labels):
                imgs = generate(labels, rng)
                pool_x = imgs if pool_x is None else np.concatenate([pool_x, imgs])
                pool_y = (labels.astype(np.int32) if pool_y is None
                          else np.concatenate([pool_y, labels.astype(np.int32)]))
            aug = p0
            if pool_y is not None and len(pool_y) >= 2:
                steps = h * cell["rsu_steps_factor"]
                idx = rng.integers(0, len(pool_y), size=(steps, B))
                x = to_device(pool_x[idx], device)
                y = torch.from_numpy(pool_y[idx].astype(np.int64)).to(device)
                aug, aug_loss = M.sgd(p0, [(x[i], y[i]) for i in range(steps)], lr, prec,
                                      half_batch="aug" in half_batch)

        # vehicles that stay in coverage through the round train h steps
        sel = plan["selected"]
        xs = np.array([state["fleet"][j]["x"] for j in sel], np.float64)
        vs = np.array([state["fleet"][j]["v"] for j in sel], np.float64)
        survive = S.holding_times(c, xs, vs) >= min(plan["t_bar"], c["t_max"])
        models, losses, sizes, emds = [], [], [], []
        for pos, j in enumerate(sel):
            if not survive[pos]:
                continue
            ix = data.parts[int(state["parts"][j])]
            if len(ix) < 2:
                continue
            idx = rng.integers(0, len(ix), size=(h, B))
            x = to_device(data.images[ix[idx]], device)
            y = torch.from_numpy(data.labels[ix[idx]].astype(np.int64)).to(device)
            m, loss = M.sgd(p0, [(x[i], y[i]) for i in range(h)], lr, prec,
                            half_batch="vehicles" in half_batch)
            models.append(m)
            losses.append(loss)
            sizes.append(fleet[j]["data_size"])
            emds.append(fleet[j]["emd"])

    rho = np.asarray(sizes, np.float64) / max(float(np.sum(sizes)), 1.0)
    kappa = S.kappas(float(np.mean(emds))) if aug is not None and emds else (1.0, 0.0)
    return {"plan": plan, "aug": aug, "aug_loss": aug_loss, "models": models, "rho": rho,
            "kappa": kappa, "loss": float(np.mean(losses)) if losses else 0.0,
            "new": eq4(p0, models, rho, kappa, aug), "pool": (pool_x, pool_y)}
