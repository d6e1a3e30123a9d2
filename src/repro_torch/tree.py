"""Parameter trees (nested dicts and lists of tensors) of the port.

Leaves go in the JAX package's tree order (dict keys sorted, lists in
order), so `tree_leaves` and a `FlatSpec` buffer line up with
`jax.tree.leaves` of the reference's tree.
"""
from __future__ import annotations

import torch


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the matching leaves of the trees
    in `rest`, which share its structure), rebuilt as `tree`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *vs) for vs in zip(tree, *rest)]
    return fn(tree, *rest)


class FlatSpec:
    """Layout of a parameter tree in one flat buffer [P]."""

    def __init__(self, tree):
        leaves = tree_leaves(tree)
        self.shapes = [tuple(x.shape) for x in leaves]
        self.sizes = [x.numel() for x in leaves]
        self.numel = sum(self.sizes)
        counter = iter(range(len(leaves)))

        def skeleton(node):
            if isinstance(node, dict):
                return {k: skeleton(node[k]) for k in sorted(node)}
            if isinstance(node, (list, tuple)):
                return [skeleton(v) for v in node]
            return next(counter)
        self.skeleton = skeleton(tree)   # the tree with leaf indices

    def flatten(self, tree) -> torch.Tensor:
        leaves = tree_leaves(tree)
        if [tuple(x.shape) for x in leaves] != self.shapes:
            raise ValueError("tree does not match the flat layout")
        return torch.cat([x.reshape(-1) for x in leaves])

    def unflatten(self, flat: torch.Tensor):
        """The tree as views of `flat` (works under `torch.func.vmap`)."""
        parts = [p.reshape(s) for p, s in
                 zip(torch.split(flat, self.sizes), self.shapes)]
        return tree_map(lambda i: parts[i], self.skeleton)
