"""Logical activation-sharding constraints, the JAX package's
`distributed/autoshard.py` with the same state.

Model code annotates activations with *logical* axes ("batch", "model")
through `aconstrain`; the launcher activates a mapping to physical mesh
axes around a trace (`activation_sharding`). A logical axis maps to its
mesh axes only where their size divides the dim and the dim is at least
that size; any other dim is unsharded (never padded).

The mesh given to `activation_sharding` is either a description
(`launch.mesh.MeshSpec`: axis names and sizes) or a
`torch.distributed.device_mesh.DeviceMesh`. Under a DeviceMesh, a DTensor
that reaches `aconstrain` is redistributed to the placements that the JAX
package's `with_sharding_constraint` would pin: `Shard(i)` on each mesh
axis of dim i's logical axis, `Replicate()` on every other mesh axis (a
pending partial sum is reduced there). A plain tensor, or any tensor
outside the context or under a description, is returned unchanged: a
layout never changes values, so the port's unsharded runs stay bitwise.

`local` runs a function on the DTensors' local shards, for the ops that
DTensor has no sharding strategy for (cache writes by index, the plain
loops over the sequence or kv chunks, the vocab-sharded embedding and
cross entropy): the caller names the placements, which are those the JAX
constraints pin, and a plain call stays a plain call.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_STATE = {"batch": None, "model": None, "sizes": {}, "mesh": None}
_REGISTERED = []


def _register_strategies():
    """DTensor sharding strategies for the ops of the models that DTensor
    has none for, registered once: `log_sigmoid_backward` (the mLSTM's
    forget gate in training), elementwise like its forward."""
    if _REGISTERED:
        return
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad_output, x, buffer):
        out = [([Replicate()], [Replicate(), Replicate(), Replicate()])]
        for d in range(x.ndim):
            buf = Shard(d) if buffer.ndim == x.ndim else Replicate()
            out.append(([Shard(d)], [Shard(d), Shard(d), buf]))
        return out

    _REGISTERED.append(_log_sigmoid_backward)


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


@contextmanager
def activation_sharding(mesh, *, batch_axes: Optional[Tuple[str, ...]] = None,
                        model_axis: str = "model"):
    """Activate logical->physical axis mapping for traces inside the block."""
    if _is_device_mesh(mesh):
        _register_strategies()
        names = list(mesh.mesh_dim_names)
        sizes = dict(zip(names, mesh.shape))
    else:
        names = list(mesh.shape.keys())
        sizes = dict(mesh.shape)
    if batch_axes is None:
        batch_axes = tuple(n for n in names if n in ("pod", "data")) or None
    old = dict(_STATE)
    _STATE.update(batch=tuple(batch_axes) if batch_axes else None,
                  model=model_axis if model_axis in names else None,
                  sizes=sizes, mesh=mesh if _is_device_mesh(mesh) else None)
    try:
        yield
    finally:
        _STATE.clear()
        _STATE.update(old)
        _STATE.setdefault("sizes", {})


def _size(ax) -> int:
    sizes = _STATE["sizes"]
    if isinstance(ax, tuple):
        s = 1
        for a in ax:
            s *= sizes.get(a, 1)
        return s
    return sizes.get(ax, 1)


def _physical(shape, logical) -> list:
    """The JAX rule: per dim, the mesh axes of its logical axis where they
    divide it, else None."""
    spec = []
    for dim, l in enumerate(logical):
        ax = _STATE["batch"] if l == "batch" else (
            _STATE["model"] if l == "model" else None)
        if ax is not None:
            n = _size(ax)
            if n > 1 and shape[dim] % n == 0 and shape[dim] >= n:
                spec.append(ax)
                continue
        spec.append(None)
    return spec


def sharded_mesh():
    """The active DeviceMesh, or None (inactive, or under a description)."""
    return _STATE["mesh"]


def placements(shape, logical: Sequence[Optional[str]]):
    """DTensor placements on the active DeviceMesh of a tensor of `shape`
    constrained to `logical` (per dim 'batch' | 'model' | None); None
    without an active DeviceMesh."""
    if _STATE["mesh"] is None:
        return None
    from repro_torch.distributed.sharding import placements as spec_placements
    return spec_placements(_physical(shape, logical), _STATE["mesh"])


def _dtensor(x) -> bool:
    return isinstance(x, DTensor)


def aconstrain(x, logical: Sequence[Optional[str]]):
    """logical: per-dim 'batch' | 'model' | None. Under a DeviceMesh a
    DTensor is redistributed to the pinned placements; anything else is
    returned unchanged (module docstring)."""
    if _STATE["mesh"] is None or x.ndim != len(logical) or not _dtensor(x):
        return x
    return x.redistribute(_STATE["mesh"], placements(x.shape, logical))


def local(fn, in_placements, out_placements):
    """fn on local shards (module docstring): `torch.distributed.tensor.
    experimental.local_map` on the active DeviceMesh, with each DTensor
    argument redistributed to its entry of `in_placements` (None for an
    argument that is not a tensor) and each output a DTensor of its entry
    of `out_placements`. An argument whole over a mesh axis that splits
    another argument or an output gets its gradient as a pending sum over
    that axis (each shard adds its own part). Without an active
    DeviceMesh, fn itself."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return fn
    from torch.distributed.tensor.experimental import local_map
    outs = out_placements if out_placements and not hasattr(out_placements[0], "is_shard") \
        else (out_placements,)
    split = [any(pl is not None and not pl[i].is_replicate()
                 for pl in tuple(in_placements) + tuple(outs)) for i in range(mesh.ndim)]
    grads = tuple(None if pl is None else
                  tuple(Partial() if split[i] and pl[i].is_replicate() else pl[i]
                        for i in range(mesh.ndim)) for pl in in_placements)

    def call(*args):
        if not any(_dtensor(a) for a in args):
            return fn(*args)
        # a plain tensor argument is whole on every rank: replicated
        args = [_replicated(a, mesh) if isinstance(a, torch.Tensor) and not _dtensor(a)
                and pl is not None else a for a, pl in zip(args, in_placements)]
        args = [_GradAsInput.apply(a) if _dtensor(a) and a.requires_grad else a for a in args]
        return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                         in_grad_placements=grads, device_mesh=mesh,
                         redistribute_inputs=True)(*args)
    return call


class _GradAsInput(torch.autograd.Function):
    """Identity whose backward lays the gradient out as the input was (its
    pending sums reduced there; a mesh axis where the input was itself a
    pending sum keeps the gradient as it comes), so that it meets the
    input's other gradients in one layout."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        pl = tuple(q if p.is_partial() else p for p, q in zip(ctx.placements, g.placements))
        return g if pl == tuple(g.placements) else g.redistribute(ctx.mesh, pl)


def _replicated(t, mesh):
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def settle(x, logical: Sequence[Optional[str]]):
    """A DTensor with a pending sum over a mesh axis is reduced there into
    the placement `logical` pins for that axis (a reduce-scatter or an
    all-reduce), before an op that cannot take a pending sum (a bias add);
    anything else is returned unchanged."""
    if _STATE["mesh"] is None or not _dtensor(x) \
            or not any(p.is_partial() for p in x.placements):
        return x
    pin = placements(x.shape, logical)
    pl = tuple(pin[i] if p.is_partial() else p for i, p in enumerate(x.placements))
    return x.redistribute(x.device_mesh, pl)


def gather_seq(x):
    """A DTensor [B, ..., d] split over a mesh axis on a dim between the
    batch and the last (a sequence split) is gathered over that axis;
    anything else is returned unchanged."""
    if _STATE["mesh"] is None or not _dtensor(x):
        return x
    pl = tuple(Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1 else p
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def split_last(x, *sizes):
    """x.reshape(*x.shape[:-1], *sizes). A DTensor split over one mesh
    axis on its last dim keeps that split on the leading factor where
    sizes[0] divides by the axis; it is gathered first where it does not,
    or where more than one mesh axis splits the dim (DTensor cannot split
    one mesh axis over two dims)."""
    if _STATE["mesh"] is not None and _dtensor(x):
        last = x.ndim - 1
        split = [i for i, p in enumerate(x.placements) if p.is_shard(last)]
        if len(split) > 1 or (split and sizes[0] % x.device_mesh.size(split[0])):
            pl = tuple(Replicate() if i in split else p for i, p in enumerate(x.placements))
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], *sizes)


def merge_last(x):
    """x.reshape(*x.shape[:-2], -1). A DTensor is merged on its local
    shards, so that the gradient reaches the split dims in the layout the
    forward had (DTensor cannot split a mesh axis that the gradient of the
    merged dim carries over two dims); a split of the last dim is gathered
    first."""
    if _STATE["mesh"] is None or not _dtensor(x):
        return x.reshape(*x.shape[:-2], -1)
    pl = tuple(Replicate() if p.is_shard(x.ndim - 1) else p for p in x.placements)
    return local(lambda t: t.reshape(*t.shape[:-2], -1), (pl,), (pl,))(x)


def write_local(write, cache: dict, *updates):
    """write(cache, *updates), an in-place write into a dict of cache
    tensors. Where the cache holds DTensors, each update is first
    redistributed to the placements of the cache leaf of its rank (a
    scatter into a sharded cache takes the cache's layout), and the write
    runs on the local shards. Returns the cache."""
    if _STATE["mesh"] is None or not any(_dtensor(v) for v in cache.values()):
        write(cache, *updates)
        return cache
    mesh = next(iter(cache.values())).device_mesh
    # a write picks slots by index: each leaf's slot dim (1) is made whole
    work, by_rank = {}, {}
    for key, v in cache.items():
        pl = tuple(Replicate() if p.is_shard(1) else p for p in v.placements)
        work[key] = v if pl == tuple(v.placements) else v.redistribute(mesh, pl)
        by_rank.setdefault(v.ndim, pl)
    local_cache = {key: w.to_local() for key, w in work.items()}
    updates = [u if _dtensor(u) else _replicated(u, mesh) for u in updates]
    write(local_cache, *[u.redistribute(mesh, by_rank[u.ndim]).to_local() for u in updates])
    for key, v in cache.items():
        if work[key] is not v:
            v.to_local().copy_(work[key].redistribute(mesh, v.placements).to_local())
    return cache


def partial_over_model(pl):
    """`pl` with the model axis of the active DeviceMesh a pending sum
    (None, the placements without a DeviceMesh, stays None)."""
    if pl is None:
        return None
    names = list(_STATE["mesh"].mesh_dim_names)
    return tuple(Partial() if names[i] == _STATE["model"] else p for i, p in enumerate(pl))


def model_coordinate() -> int:
    """This rank's index along the model axis of the active DeviceMesh (0
    without one)."""
    mesh = _STATE["mesh"]
    if mesh is None or _STATE["model"] is None:
        return 0
    return mesh.get_local_rank(_STATE["model"])


def active() -> bool:
    return _STATE["batch"] is not None or _STATE["model"] is not None


def logical_size(name: str) -> int:
    """Physical size of a logical axis in the active context (1 if inactive)."""
    ax = _STATE["batch"] if name == "batch" else (
        _STATE["model"] if name == "model" else None)
    return _size(ax) if ax is not None else 1
