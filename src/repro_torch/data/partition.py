"""Dirichlet non-IID partitioning (paper Sec. VI-A1): lower alpha =>
more heterogeneous per-vehicle label distributions."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        rng: np.random.Generator,
                        min_size: int = 8) -> List[np.ndarray]:
    """Split sample indices across clients with per-class Dir(alpha) shares.

    Returns a list of index arrays (one per client, shuffled)."""
    labels = np.asarray(labels)
    classes = int(labels.max()) + 1
    for _ in range(100):
        idx_per_client: List[list] = [[] for _ in range(n_clients)]
        for c in range(classes):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for cl, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[cl].extend(part.tolist())
        sizes = [len(ix) for ix in idx_per_client]
        if min(sizes) >= min_size:
            break
    out = []
    for ix in idx_per_client:
        arr = np.array(ix, np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out
