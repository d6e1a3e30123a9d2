"""Mesh descriptions for the dry-run and the sharding rules.

A mesh here is a description, not a process group: axis names and sizes,
which is all the sharding rules and the roofline terms read. The
production meshes are the JAX package's (16x16 one pod, 2x16x16 two);
no process group of 256 ranks is needed or created. `make_host_mesh`
describes the cards this process can see.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch


@dataclass(frozen=True)
class MeshSpec:
    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        return "x".join(map(str, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """16x16 (256 chips) single pod; 2x16x16 (512 chips) multi-pod."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1) -> MeshSpec:
    """Small mesh over the locally visible cards (1 on the CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if data * model > n:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} cards, "
                         f"{n} visible")
    return MeshSpec(("data", "model"), (data, model))
