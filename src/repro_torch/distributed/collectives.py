"""GenFV aggregation as a collective.

The paper's eq. (4) — kappa1 * sum_n rho_n w_n + kappa2 * w_a — is a
*weighted all-reduce*: each cohort holds its locally-updated model and a
scalar weight (rho_n * kappa1 for vehicle cohorts, kappa2 for the RSU's
augmented cohort); the global model is the sum over cohorts of weight x
model. The JAX package computes it as a `psum` under `shard_map` over a
mesh axis, with the cohorts stacked on axis 0. Here each rank of a
`torch.distributed` process group holds one cohort and calls the function
with its own model and weight: NCCL on the card, gloo on the CPU.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import FlatSpec, tree_map


def genfv_weighted_allreduce(model, weight, group=None):
    """model: this rank's cohort model, a tree of tensors (dicts and lists);
    weight: its scalar weight (the weights of all ranks already normalized:
    they sum to 1, e.g. [k1*rho_1, ..., k1*rho_N, k2]).

    Returns, on every rank, the tree of float32 sums over the group's ranks
    of weight x model: each leaf is cast to float32 and multiplied by the
    float32 weight, as the JAX package does, and the leaves go through one
    all-reduce (SUM) of a flat buffer."""
    layout = FlatSpec(model)
    flat = layout.flatten(tree_map(lambda x: x.float(), model))
    flat = flat * torch.tensor(weight, dtype=torch.float32, device=flat.device)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return layout.unflatten(flat)
