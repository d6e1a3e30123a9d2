"""The procedural image classes, the oracle AIGC generator, the Dirichlet
partition and the EMD, in NumPy.

Each class of a dataset is a fixed low-frequency pattern: a coarse shape
shared by the class pair (cls // 2) plus a texture of its own. Real images
are 0.8 x the rolled class pattern plus noise; the oracle generator
reproduces the shape and 0.4 of the texture (a generator's quality gap).
"""
from __future__ import annotations

import zlib
from functools import lru_cache

import numpy as np

IMG = 32


def _seed(*key) -> int:
    return zlib.crc32("/".join(map(str, key)).encode())


def _waves(seed: int, f_lo: float, f_hi: float, n: int = 4) -> np.ndarray:
    rng = np.random.default_rng(seed % (2 ** 31))
    yy, xx = np.mgrid[0:IMG, 0:IMG].astype(np.float64) / IMG
    img = np.zeros((IMG, IMG, 3))
    for _ in range(n):
        fx, fy = rng.uniform(f_lo, f_hi, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        amp = rng.uniform(0.3, 1.0, 3)
        img += (np.sin(2 * np.pi * (fx * xx + px))
                * np.cos(2 * np.pi * (fy * yy + py)))[..., None] * amp
    img /= np.abs(img).max() + 1e-9
    return img.astype(np.float32)


@lru_cache(maxsize=None)
def coarse(name: str, cls: int) -> np.ndarray:
    return _waves(_seed(name, "coarse", cls // 2), 0.5, 2.5)


@lru_cache(maxsize=None)
def fine(name: str, cls: int) -> np.ndarray:
    return _waves(_seed(name, "fine", cls), 6.0, 12.0)


def class_patterns(name: str, classes: int) -> np.ndarray:
    """[classes, 32, 32, 3] float32 in [-1, 1]."""
    out = []
    for c in range(classes):
        img = 0.6 * coarse(name, c) + 0.4 * fine(name, c)
        out.append((img / (np.abs(img).max() + 1e-9)).astype(np.float32))
    return np.stack(out)


def oracle_images(name: str, labels: np.ndarray, rng: np.random.Generator,
                  fine_frac: float = 0.4, noise: float = 0.30) -> np.ndarray:
    """The oracle generator's images for `labels`, drawing from `rng` the
    shifts (integers in [-4, 4], [n, 2]) and then the noise
    (normal(0, noise), [n, 32, 32, 3])."""
    n = len(labels)
    if n == 0:
        return np.empty((0, IMG, IMG, 3), np.float32)
    shifts = rng.integers(-4, 5, size=(n, 2))
    eps = rng.normal(0, noise, size=(n, IMG, IMG, 3)).astype(np.float32)
    out = np.empty((n, IMG, IMG, 3), np.float32)
    for i, c in enumerate(labels):
        p = 0.6 * coarse(name, int(c)) + (0.4 * float(fine_frac)) * fine(name, int(c))
        out[i] = np.clip(0.8 * np.roll(p, tuple(shifts[i]), axis=(0, 1)) + eps[i], -1, 1)
    return out


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        rng: np.random.Generator, min_size: int = 8) -> list:
    """Per class, Dir(alpha) shares of its shuffled indices; redrawn until
    every client holds `min_size`; each client's indices shuffled."""
    labels = np.asarray(labels)
    for _ in range(100):
        parts = [[] for _ in range(n_clients)]
        for c in range(int(labels.max()) + 1):
            idx = np.flatnonzero(labels == c)
            rng.shuffle(idx)
            cuts = (np.cumsum(rng.dirichlet(np.full(n_clients, alpha)))
                    * len(idx)).astype(int)[:-1]
            for k, part in enumerate(np.split(idx, cuts)):
                parts[k].extend(part.tolist())
        if min(len(p) for p in parts) >= min_size:
            break
    out = []
    for p in parts:
        arr = np.array(p, np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out


def emd(hist: np.ndarray) -> float:
    """Eq. 3's EMD_n against the uniform label distribution."""
    hist = np.asarray(hist, np.float64)
    return float(np.abs(hist - np.full_like(hist, 1.0 / hist.shape[-1])).sum(-1))
