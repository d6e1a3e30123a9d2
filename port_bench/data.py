"""The cell's images, made from the seed on the device in a few calls.

Train labels come from the traffic mix's `world_seed`, so every seed of a
cell gives the runner the same label partition, the same road and the same
fleets: the seed changes the pixels and the weights, not the work. The test
labels and all pixels come from `--seed`. An image is 0.8 x its class
pattern rolled by a shift in [-3, 3] on each axis, plus N(0, 0.25) noise,
clipped to [-1, 1]; NHWC float32 on the host, as the program takes them.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.data import class_patterns

NOISE = 0.25
SHIFT = 3


def _images(patterns: torch.Tensor, labels: torch.Tensor, gen: torch.Generator,
            chunk: int = 8192) -> np.ndarray:
    n, size = len(labels), patterns.shape[1]
    dev = patterns.device
    shifts = torch.randint(-SHIFT, SHIFT + 1, (n, 2), generator=gen, device=dev)
    out = np.empty((n, size, size, 3), np.float32)
    ar = torch.arange(size, device=dev)
    for i in range(0, n, chunk):
        lab, sh = labels[i:i + chunk], shifts[i:i + chunk]
        rows = (ar[None, :] - sh[:, :1]) % size
        cols = (ar[None, :] - sh[:, 1:]) % size
        pats = patterns[lab[:, None, None], rows[:, :, None], cols[:, None, :]]
        eps = torch.randn(pats.shape, generator=gen, device=dev) * NOISE
        out[i:i + chunk] = torch.clamp(0.8 * pats + eps, -1.0, 1.0).cpu().numpy()
    return out


def make_datasets(dataset: str, classes: int, train_size: int, test_size: int,
                  world_seed: int, seed: int, device):
    """((train images, train labels), (test images, test labels)), numpy."""
    train_labels = np.random.default_rng([world_seed, 1]).integers(
        0, classes, size=train_size).astype(np.int32)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    patterns = torch.from_numpy(class_patterns(dataset, classes)).to(device)
    test_labels = torch.randint(0, classes, (test_size,), generator=gen, device=device)
    train = _images(patterns, torch.from_numpy(train_labels).long().to(device), gen)
    test = _images(patterns, test_labels, gen)
    return ((train, train_labels),
            (test, test_labels.cpu().numpy().astype(np.int32)))
