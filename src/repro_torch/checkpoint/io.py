"""Checkpointing of the port: a tree <-> .npz with path-string keys + a
JSON manifest (the counterpart of the JAX package's `checkpoint/io.py`).

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or scalars; leaves go in the JAX package's tree order (dict keys
sorted, sequences in order) and each is stored under its path
("params/conv1/w"), so checkpoints are inspectable with plain numpy.
Tensors are copied to the host and written as numpy arrays.

Writes are ATOMIC: the archive is assembled in a temporary file in the same
directory, flushed and fsynced, then `os.replace`d into place, so a crash
mid-write never corrupts an existing resume point.

`restore_tree` reloads standalone (numpy leaves, dicts/lists/tuples
rebuilt from the manifest); `restore_into` reloads into a template tree
(shapes checked; a tensor leaf of the template comes back as a tensor on
its device); `read_manifest` returns the manifest (keys, structure,
metadata) without reading any array.
"""
from __future__ import annotations

import json
import os
from typing import Any, Iterator, Tuple

import numpy as np
import torch


def _leaves_with_paths(tree, path: Tuple = ()) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _json_default(o):
    """Manifest metadata may carry numpy scalars (a np.float64 knob, an
    int64 round index)."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    raise TypeError(f"manifest metadata is not JSON-serializable: "
                    f"{type(o).__name__}")


def _structure_of(tree) -> Any:
    """JSON-serializable skeleton: leaves -> None, dict items in sorted key
    order (the order the leaves are written in)."""
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _structure_of(tree[k])
                          for k in sorted(tree.keys())}}
    if isinstance(tree, (list, tuple)):
        return {"__kind__": type(tree).__name__,
                "items": [_structure_of(v) for v in tree]}
    return None


def save_tree(path: str, tree: Any, metadata: dict | None = None) -> str:
    """Atomically write `tree` to `path` (.npz appended if missing, as
    np.savez does). Returns the final path."""
    arrays = {}
    keys = []
    for p, leaf in _leaves_with_paths(tree):
        k = p or "leaf"
        keys.append(k)
        arrays[k] = _host_array(leaf)
    manifest = {"keys": keys, "structure": _structure_of(tree),
                "metadata": metadata or {}}
    if not path.endswith(".npz"):
        path += ".npz"
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # temp file in the SAME directory so os.replace is an atomic rename
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __manifest__=json.dumps(
                manifest, default=_json_default), **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):           # only on failure: replace consumed it
            os.unlink(tmp)
    return path


def _fill(skel, leaves_iter):
    if skel is None:
        return next(leaves_iter)
    if skel["__kind__"] == "dict":
        return {k: _fill(v, leaves_iter) for k, v in skel["items"].items()}
    items = [_fill(v, leaves_iter) for v in skel["items"]]
    return items if skel["__kind__"] == "list" else tuple(items)


def read_manifest(path: str) -> dict:
    """The checkpoint's manifest (keys, structure skeleton, metadata) without
    loading any array payloads."""
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["__manifest__"]))


def _read(path: str):
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["__manifest__"]))
        return manifest, [data[k] for k in manifest["keys"]]


def restore_tree(path: str) -> Any:
    manifest, leaves = _read(path)
    return _fill(manifest["structure"], iter(leaves))


def restore_into(template: Any, path: str) -> Any:
    manifest, leaves = _read(path)
    t_leaves = [leaf for _, leaf in _leaves_with_paths(template)]
    if len(t_leaves) != len(leaves):
        raise ValueError(f"leaf count mismatch: template {len(t_leaves)} "
                         f"vs checkpoint {len(leaves)}")
    for t, l in zip(t_leaves, leaves):
        if tuple(np.shape(t)) != tuple(l.shape):
            raise ValueError(f"shape mismatch {tuple(np.shape(t))} vs "
                             f"{l.shape}")
    out = [torch.from_numpy(l).to(t.device) if isinstance(t, torch.Tensor)
           else l for t, l in zip(t_leaves, leaves)]
    return _fill(_structure_of(template), iter(out))
