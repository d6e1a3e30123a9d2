"""AIGC generation service of the port's GenFV server: `OracleGenerator`,
a copy of the JAX package's (`generate(labels, rng, round_idx=0) ->
images`, the same draws and float ops, so the same images bit for bit).

The oracle is a procedural sampler with a controllable *quality gap*
(blur + noise + pattern distortion), standing in for a pre-trained
foundation model at RSU scale; it honours SUBP4's per-label schedule. The
real diffusion dataplane (`DDPMGenerator`) is not ported yet.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from repro_torch.data.synthetic import IMG, _coarse_pattern, _fine_pattern

#: every dataset's full class set (cifar100's 100 is the max) times a
#: handful of fine_frac variants fits; beyond that, eviction beats the
#: unbounded growth a multi-dataset sweep used to accumulate (each entry
#: is a 12 KiB [32,32,3] float32 pattern).
ORACLE_CACHE_SIZE = 512


@lru_cache(maxsize=ORACLE_CACHE_SIZE)
def _oracle_pattern(dataset: str, cls: int, fine_frac: float) -> np.ndarray:
    """Degraded per-class pattern, keyed per (dataset, class, fine_frac):
    full coarse shape, fine_frac of the texture (same float op order as the
    original per-image computation)."""
    return (0.6 * _coarse_pattern(dataset, cls)
            + (0.4 * float(fine_frac)) * _fine_pattern(dataset, cls))


class OracleGenerator:
    """Quality gap model: the generator reproduces the coarse per-class
    'shape' faithfully but only `fine_frac` of the high-frequency per-class
    'texture' (data/synthetic.py builds real samples from 0.6*coarse +
    0.4*fine). Consequences, mirroring the paper's Fig. 10-12:
    * AIGC-only models plateau below the real-data ceiling (the weak
      texture signal limits within-pair discrimination), and
    * the generated data stays in-distribution, so the augmented model's
      weights average productively into the federated model (eq. 4) —
      a fully out-of-distribution generator makes weight blending
      destructive (observed and recorded in EXPERIMENTS.md)."""

    def __init__(self, dataset: str, fine_frac: float = 0.4,
                 noise: float = 0.30):
        self.dataset = dataset
        self.fine_frac = fine_frac
        self.noise = noise

    def generate(self, labels: np.ndarray, rng: np.random.Generator,
                 round_idx: int = 0):
        """Vectorized: one batched pattern lookup + gather-roll instead of a
        per-image Python loop (this sits on the per-round hot path of every
        AIGC strategy). Bitwise-identical to the loop form: the rng draw
        order (shifts, then noise) and float op order are preserved, and the
        roll is expressed as the equivalent modular gather."""
        labels = np.asarray(labels)
        n = len(labels)
        if n == 0:
            return np.empty((0, IMG, IMG, 3), np.float32)
        shifts = rng.integers(-4, 5, size=(n, 2))
        eps = rng.normal(0, self.noise,
                         size=(n, IMG, IMG, 3)).astype(np.float32)
        classes, inv = np.unique(labels, return_inverse=True)
        bank = np.stack([_oracle_pattern(self.dataset, int(c), self.fine_frac)
                         for c in classes])
        pats = bank[inv]                                   # [n, IMG, IMG, 3]
        # np.roll(p, (s0, s1), axis=(0, 1)) == p[(i - s0) % IMG, (j - s1) % IMG]
        rows = (np.arange(IMG)[None, :] - shifts[:, :1]) % IMG
        cols = (np.arange(IMG)[None, :] - shifts[:, 1:]) % IMG
        rolled = pats[np.arange(n)[:, None, None],
                      rows[:, :, None], cols[:, None, :]]
        return np.clip(0.8 * rolled + eps, -1, 1)
