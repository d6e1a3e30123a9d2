"""Mesh descriptions for the dry-run and the sharding rules.

A mesh here is a description, not a process group: axis names and sizes,
which is all the sharding rules and the roofline terms read. The
production meshes are the JAX package's (16x16 one pod, 2x16x16 two).
`make_host_mesh` describes the cards this process can see.

`device_mesh` turns a description into a
`torch.distributed.device_mesh.DeviceMesh` with the same axis names and
sizes, for the sharded steps (DTensor). Where the process has no group it
creates one and destroys it on leaving: by default a `fake` group of
`spec.size` ranks (this process is rank 0; its collectives move nothing),
which is how the dry-run counts the collectives of a 256- or 512-card
mesh in one process. A caller with a real group (gloo, NCCL) of
`spec.size` ranks gets the mesh over that group.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.distributed as dist


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


def fold_pods(spec: MeshSpec) -> MeshSpec:
    """`spec` with its "pod" axis folded into "data" (pod major): 2x16x16
    becomes 32x16. The sharding rules never split pod from data (every
    spec names them together, pod first, and the batch axes are the
    same pair), so the folded mesh lays every tensor out on the same
    ranks; DTensor plans a step on a three-dim mesh far more slowly."""
    if "pod" not in spec.axis_names:
        return spec
    shape = spec.shape
    return MeshSpec(("data", "model"), (shape["pod"] * shape["data"], shape["model"]))


@contextlib.contextmanager
def device_mesh(spec: MeshSpec, device_type: str = "cuda"):
    """A DeviceMesh of `spec`'s axis names and sizes (module docstring).

    Without a process group, a fake one of spec.size ranks is created
    and destroyed on leaving. The fake mesh's device type defaults to
    "cuda" (nothing is placed on a device; the type only picks DTensor's
    collectives, and on "cpu" it replaces each all-to-all by an all-gather
    because gloo has none). With a group, its world size must equal
    spec.size, and device_type names its devices ("cpu" for gloo)."""
    from torch.distributed.device_mesh import init_device_mesh
    created = not dist.is_initialized()
    if created:
        dist.init_process_group("fake", rank=0, world_size=spec.size)
    try:
        if dist.get_world_size() != spec.size:
            raise ValueError(f"a {spec.name} mesh needs {spec.size} ranks, the "
                             f"process group has {dist.get_world_size()}")
        mesh = init_device_mesh(device_type, spec.axis_sizes, mesh_dim_names=spec.axis_names)
        if mesh.ndim > 1:
            mesh._flatten()
        yield mesh
    finally:
        if created:
            dist.destroy_process_group()
