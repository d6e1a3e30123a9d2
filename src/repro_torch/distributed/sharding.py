"""Sharding rules for the production mesh, the JAX package's
`distributed/sharding.py` rule for rule.

Strategy: FSDP+TP hybrid, *divisibility-aware* — a dimension is only sharded
if the mesh axis divides it exactly (no silent padding):

* params: the largest dim divisible by |model| is tensor-sharded over
  'model' (heads / d_ff / experts / vocab end up here naturally); a second
  dim divisible by |fsdp| = |pod|x|data| is FSDP-sharded.
* batch: global batch over ('pod','data'); decode long_500k (batch=1)
  replicates the token and shards the *cache* instead.
* caches: batch over ('pod','data') when divisible, then kv-heads over
  'model', falling back to head_dim, falling back to replication.

A mesh is anything with a `.shape` mapping axis name -> size
(`launch.mesh.MeshSpec`). A spec is a tuple with one entry per tensor dim:
None, an axis name, or a tuple of two or more axis names (the counterpart
of a `PartitionSpec`, which writes a tuple of one name as the name). The rules return a tree of specs shaped like their
input; a leaf that is not a tensor (the optimizer's step count) gets ().

The JAX package stacks the layers of each pattern group over a leading
group axis G and keeps the last num_layers % len(pattern) layers apart
("rem"); the port keeps one list of layers. A port leaf of layer i is
therefore the JAX leaf [G, *shape] when i < G * len(pattern) (and every
whisper encoder layer), else the JAX leaf of the same shape. The rules
take the JAX rule of that JAX shape and drop the group entry, so the
JAX rule's rank test (`len(shape) >= 3` skips the leading dim) is decided
by where the layer came from, never by the port leaf's own rank. Where
the JAX rule shards the G axis itself (the [G, d] norm scales of
grok-1-314b, llava-next-mistral-7b and olmoe-1b-7b on a 16x16 mesh, where
G divides by 16), a per-layer leaf cannot say so: its spec keeps the other
entries, and `per_device_bytes` counts it 16 times the JAX leaf's share.

`placements` and `distribute` take a spec tree onto a
`torch.distributed.device_mesh.DeviceMesh` (`launch.mesh.device_mesh`):
an axis name at dim i is `Shard(i)` on that mesh dim, a tuple of names is
`Shard(i)` on each of them (major to minor, as a PartitionSpec reads),
None is `Replicate()`.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.configs.base import ModelConfig

Spec = tuple


def _axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    s = 1
    for n in names:
        s *= mesh.shape[n]
    return s


def shard_leaf(shape: Sequence[int], mesh, *, model_axis="model",
               fsdp_axes=None, skip_leading: bool = False) -> Spec:
    """Pick a spec for one parameter leaf."""
    fsdp_axes = fsdp_axes if fsdp_axes is not None else _default_fsdp(mesh)
    ndim = len(shape)
    spec = [None] * ndim
    start = 1 if (skip_leading and ndim >= 3) else 0
    dims = sorted(range(start, ndim), key=lambda i: -shape[i])

    m = _axis_size(mesh, model_axis)
    used = None
    for i in dims:
        if shape[i] % m == 0 and shape[i] >= m:
            spec[i] = model_axis
            used = i
            break
    f = _axis_size(mesh, fsdp_axes)
    for i in dims:
        if i != used and shape[i] % f == 0 and shape[i] >= f:
            spec[i] = _entry(fsdp_axes)
            break
    return tuple(spec)


def _default_fsdp(mesh):
    names = list(mesh.shape.keys())
    fsdp = tuple(n for n in names if n in ("pod", "data"))
    return fsdp if fsdp else (names[0],)


def _entry(axes):
    """A spec entry for `axes`: one name stands alone, as a PartitionSpec
    writes ("data",) as "data"."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def _batch_axes(mesh):
    return _default_fsdp(mesh)


def _map_with_path(fn, tree, path=()):
    """fn(path, leaf) over a tree of dicts and lists, rebuilt as the tree;
    path holds the dict keys and list indices from the root."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _tensor_rule(rule):
    """rule(leaf) on tensors; () for any other leaf."""
    return lambda leaf: rule(leaf) if isinstance(leaf, torch.Tensor) else ()


def _group_count(path, cfg: ModelConfig) -> int:
    """G, where the JAX package stacks this leaf's layer over a group axis
    of G; 0 where it does not."""
    if "layers" not in path:
        return 0
    if "encoder" in path:
        return cfg.encoder_layers
    plen = len(cfg.pattern)
    G = cfg.num_layers // plen
    return G if path[path.index("layers") + 1] < G * plen else 0


def params_shardings(params: Any, mesh, cfg: ModelConfig) -> Any:
    """params: a parameter tree (meta tensors from `launch.specs`), or an
    optimizer state whose moments are such trees.

    Expert weights (path contains 'moe', shape [..., E, d_in, d_out]) are
    EXPERT-PARALLEL: the expert dim is sharded over 'model', with FSDP on
    d_in/d_out. Everything else follows the generic largest-divisible-dim
    rule."""
    m = mesh.shape.get("model", 1)
    fsdp = _default_fsdp(mesh)
    f = _axis_size(mesh, fsdp)

    def jax_rule(keys, shape):
        is_expert = ("moe" in keys and len(shape) >= 3
                     and "router" not in keys)
        if is_expert:
            edim = len(shape) - 3
            spec = [None] * len(shape)
            if shape[edim] % m == 0 and shape[edim] >= m:
                spec[edim] = "model"
                # FSDP the largest remaining matmul dim
                for i in sorted(range(edim + 1, len(shape)),
                                key=lambda i_: -shape[i_]):
                    if shape[i] % f == 0 and shape[i] >= f:
                        spec[i] = _entry(fsdp)
                        break
                return tuple(spec)
        skip = len(shape) >= 3
        return shard_leaf(shape, mesh, skip_leading=skip)

    def rule(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return ()
        G = _group_count(path, cfg)
        if G:
            return jax_rule(path, (G,) + tuple(leaf.shape))[1:]
        return jax_rule(path, tuple(leaf.shape))

    return _map_with_path(rule, params)


def batch_shardings(batch: Any, mesh) -> Any:
    """Activations/inputs: dim 0 (batch) over ('pod','data') when divisible."""
    baxes = _batch_axes(mesh)
    b = _axis_size(mesh, baxes)

    def rule(leaf):
        spec = [None] * leaf.ndim
        if leaf.ndim >= 1 and leaf.shape[0] % b == 0 and leaf.shape[0] >= b:
            spec[0] = _entry(baxes)
        return tuple(spec)
    return _map_with_path(lambda _, leaf: _tensor_rule(rule)(leaf), batch)


def cache_shardings(cache: Any, mesh) -> Any:
    """KV caches [B, cap, nkv, hd], positions [B, cap], recurrent states
    [B, w] / [B, h, hd, hd]: batch over ('pod','data'); one more dim over
    'model' when divisible (head_dim > kv-heads > width). The ring-buffer
    sequence dim of a 4-dim leaf is never sharded.

    The port's caches are per layer, so every leaf takes the rule the JAX
    package applies at offset 0 to its remainder layers, and at offset 1
    (past the group axis, which it never shards) to its stacked ones: the
    same spec with the group entry dropped."""
    baxes = _batch_axes(mesh)
    b = _axis_size(mesh, baxes)
    m = mesh.shape.get("model", 1)

    def rule(leaf):
        shape = leaf.shape
        spec = [None] * len(shape)
        dims = list(range(len(shape)))
        if dims and shape[dims[0]] % b == 0 and shape[dims[0]] >= b:
            spec[dims[0]] = _entry(baxes)
        for i in reversed(dims[1:]):
            if i == dims[0] + 1 and len(dims) == 4:
                continue   # never shard the ring-buffer seq dim of kv caches
            if shape[i] % m == 0 and shape[i] >= m:
                spec[i] = "model"
                break
        return tuple(spec)

    return _map_with_path(lambda _, leaf: _tensor_rule(rule)(leaf), cache)


def replicated(tree: Any, mesh) -> Any:
    """Every tensor leaf whole on every device. The JAX helper's
    counterpart; no launcher of the port calls it yet."""
    return _map_with_path(
        lambda _, leaf: _tensor_rule(lambda t: (None,) * t.ndim)(leaf), tree)


def per_device_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes one device holds of `tree` laid out by `specs`: each tensor
    leaf's bytes over the product of the axis sizes in its spec (the
    counterpart of the compiled step's `argument_size_in_bytes`)."""
    total = 0

    def add(path, leaf):
        nonlocal total
        if not isinstance(leaf, torch.Tensor):
            return
        spec = _lookup(specs, path)
        parts = 1
        for entry in spec:
            if entry is not None:
                parts *= _axis_size(mesh, entry)
        total += leaf.numel() * leaf.element_size() // parts

    _map_with_path(add, tree)
    return total


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of `spec` on the DeviceMesh `mesh`."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for name in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(name)] = Shard(i)
    return tuple(out)


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """The tensors of `tree` as DTensors on the DeviceMesh `mesh`, laid out
    by `specs`. A meta tensor becomes a DTensor of meta shards (nothing is
    allocated); a real tensor, which every rank must hold whole, is cut
    into its local shard with no communication. Other leaves stay."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def leaf(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        pl = placements(_lookup(specs, path), mesh)
        if t.device.type != "meta":
            return distribute_tensor(t, mesh, pl, src_data_rank=None)
        local = list(t.shape)
        for mdim, p in enumerate(pl):
            if p.is_shard():
                local[p.dim] //= mesh.size(mdim)
        return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), mesh,
                                  pl, run_check=False, shape=t.shape, stride=t.stride())

    return _map_with_path(leaf, tree)


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def describe(specs: Any, max_items: int = 20) -> str:
    """Debug helper: path -> spec lines (the JAX helper's counterpart; only
    the tests call it)."""
    lines = []

    def add(path, spec):
        lines.append(f"{'/'.join(map(str, path))}: {spec}")

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (i,))
        else:
            add(path, tree)

    walk(specs)
    return "\n".join(lines[:max_items])
