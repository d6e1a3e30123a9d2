"""Procedural image datasets, made from a seed (no downloaded data).

Image datasets mirror the paper's three benchmarks in class count and size:
cifar10 (10), cifar100 (100), gtsrb (43). Each class is a deterministic
low-frequency pattern; samples are pattern + translation + noise, so the
class structure is learnable by a CNN and by the class-conditional DDPM,
and *label distributions* (what the paper's EMD policy consumes) behave
exactly like the real thing.

A copy of the image half of the JAX package's `data/synthetic.py`: the
same seeds give the same arrays bit for bit.
"""
from __future__ import annotations

import zlib
from functools import lru_cache
from typing import Tuple

import numpy as np

DATASET_CLASSES = {"cifar10": 10, "cifar100": 100, "gtsrb": 43}
IMG = 32


def _stable_seed(*key) -> int:
    """Process-independent pattern seed. Builtin `hash()` is salted by
    PYTHONHASHSEED, which made class patterns differ between interpreter
    runs — harmless for single-process golden tests but fatal for
    cross-process checkpoint resume (and the occasional hash seed drew
    near-degenerate class pairs)."""
    return zlib.crc32("/".join(map(str, key)).encode())


def _wave_pattern(seed: int, f_lo: float, f_hi: float, n_waves: int = 4
                  ) -> np.ndarray:
    rng = np.random.default_rng(seed % (2 ** 31))
    yy, xx = np.mgrid[0:IMG, 0:IMG].astype(np.float64) / IMG
    img = np.zeros((IMG, IMG, 3))
    for _ in range(n_waves):
        fx, fy = rng.uniform(f_lo, f_hi, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        amp = rng.uniform(0.3, 1.0, 3)
        wave = np.sin(2 * np.pi * (fx * xx + px)) * np.cos(2 * np.pi * (fy * yy + py))
        img += wave[..., None] * amp
    img /= np.abs(img).max() + 1e-9
    return img.astype(np.float32)


@lru_cache(maxsize=None)
def _coarse_pattern(name: str, cls: int) -> np.ndarray:
    """Low-frequency 'shape' component — SHARED between class pairs
    (cls // 2), mimicking the coarse structure a generative model captures."""
    return _wave_pattern(_stable_seed(name, "coarse", cls // 2), 0.5, 2.5)


@lru_cache(maxsize=None)
def _fine_pattern(name: str, cls: int) -> np.ndarray:
    """High-frequency 'texture' component — unique per class. This is the
    detail that separates paired classes; the AIGC oracle cannot reproduce
    it (fl/generator.py), giving AIGC-only training its accuracy ceiling
    (paper Fig. 10-12)."""
    return _wave_pattern(_stable_seed(name, "fine", cls), 6.0, 12.0)


@lru_cache(maxsize=None)
def _class_pattern(name: str, cls: int) -> np.ndarray:
    """Deterministic pattern for (dataset, class): coarse shared shape +
    class-unique fine texture, [32,32,3] in [-1,1]."""
    img = 0.6 * _coarse_pattern(name, cls) + 0.4 * _fine_pattern(name, cls)
    return (img / (np.abs(img).max() + 1e-9)).astype(np.float32)


def make_image_dataset(name: str, n: int, seed: int = 0,
                       noise: float = 0.25,
                       labels: np.ndarray | None = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images [n,32,32,3] float32 in [-1,1], labels [n] int32)."""
    classes = DATASET_CLASSES[name]
    rng = np.random.default_rng(seed)
    if labels is None:
        labels = rng.integers(0, classes, size=n)
    labels = np.asarray(labels, np.int32)
    imgs = np.empty((n, IMG, IMG, 3), np.float32)
    shifts = rng.integers(-3, 4, size=(n, 2))
    eps = rng.normal(0.0, noise, size=(n, IMG, IMG, 3)).astype(np.float32)
    for i, c in enumerate(labels):
        p = np.roll(_class_pattern(name, int(c)), shifts[i], axis=(0, 1))
        imgs[i] = np.clip(0.8 * p + eps[i], -1.0, 1.0)
    return imgs, labels
