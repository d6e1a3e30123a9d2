"""Round-keyed AIGC generation service for the GenFV round loop, the
counterpart of the JAX package's `gen/service.py`.

`BatchedDDPMGenerator` is the `RunConfig(generator="ddpm")` implementation
of the server's generator interface: every round's full SUBP4 schedule —
all selected vehicles' per-label counts concatenated by `label_schedule` —
is sampled in one bucketed pass (gen/sampler.py).

Determinism contract (as fl/faults.py): the sampling stream of round ``t``
is keyed ``SeedSequence((seed, t, GEN_KEY))`` and the generator never
touches the runner's shared numpy Generator — so generation is a pure
function of (pretrained params, run seed, round, schedule), identical
across vectorized/sequential paths and across checkpoint resume. The
oracle keeps consuming the shared stream in the JAX package's order.

The pretrained parameters live on the device that samples (the runner's):
`_pretrained_params` caches them per configuration and device, about 4 MB
at the runner's width.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.core.planner import bucket_size
from repro_torch.diffusion.ddpm import DDPM
from repro_torch.gen.pretrain import pretrain_ddpm
from repro_torch.gen.sampler import IMAGE_SHAPE, sample_schedule
from repro_torch.models.api import resolve_device
from repro_torch.obs import NULL_OBS

#: domain tag of the generation key stream ("AIGC"), keeping it disjoint
#: from every other (seed, round)-keyed stream (fl/faults.py uses
#: 0x52545259 "RTRY" for upload retries).
GEN_KEY = 0x41494743

#: the RSU "foundation model" served for `RunConfig(generator="ddpm")`:
#: the paper's 200-step noise schedule (Sec. VI-A2) at the JAX package's
#: runner width. `RunConfig.sampler_steps` strides this schedule at
#: sampling time.
RUNNER_TIMESTEPS = 200
RUNNER_BASE_WIDTH = 16
#: reference-pool pretraining budget (gen/pretrain.py); seeded at 0
#: independent of the run seed — one pretrained generator stands in for the
#: RSU's foundation model across every run, while the per-round sampling
#: streams stay keyed by the run seed.
PRETRAIN_SEED = 0
PRETRAIN_STEPS = 80
PRETRAIN_REF = 512


def gen_round_key(seed: int, round_idx: int) -> np.random.SeedSequence:
    """The key of round ``round_idx``'s sampling stream."""
    return np.random.SeedSequence(entropy=(int(seed), int(round_idx), GEN_KEY))


def runner_ddpm(num_classes: int) -> DDPM:
    return DDPM(timesteps=RUNNER_TIMESTEPS, num_classes=num_classes,
                base_width=RUNNER_BASE_WIDTH)


@lru_cache(maxsize=4)
def _pretrained_params(dataset: str, num_classes: int, timesteps: int,
                       base_width: int, steps: int, ref_size: int, seed: int,
                       device: torch.device):
    """One reference-pool pretraining per configuration and device per
    process. The full budget is part of the cache key so a test-shrunk
    configuration never aliases the default one."""
    ddpm = DDPM(timesteps=timesteps, num_classes=num_classes,
                base_width=base_width)
    params, _ = pretrain_ddpm(ddpm, dataset=dataset, steps=steps,
                              ref_size=ref_size, seed=seed, device=device)
    return params, ddpm


class BatchedDDPMGenerator:
    """The diffusion service behind `RunConfig(generator="ddpm")`; samples
    on the device its parameters lie on.

    `generate` ignores the shared numpy Generator argument (interface
    compatibility with the oracle) and draws from the round-keyed stream
    instead; `rounds.py` threads the round index through
    `GenFVServer.generate`."""

    def __init__(self, params, ddpm: DDPM, seed: int,
                 sampler_steps: int = 50, obs=None):
        self.params = params
        self.ddpm = ddpm
        self.seed = int(seed)
        self.sampler_steps = int(sampler_steps)
        self.obs = obs if obs is not None else NULL_OBS

    def generate(self, labels: np.ndarray, rng: np.random.Generator,
                 round_idx: int = 0) -> np.ndarray:
        labels = np.asarray(labels, np.int32)
        n = len(labels)
        if n == 0:
            return np.empty((0,) + IMAGE_SHAPE, np.float32)
        bucket = bucket_size(n)
        obs = self.obs
        if obs.enabled:
            obs.count("gen/images", n)
            obs.observe("gen/pad_waste", bucket - n)
        # the span key is the JAX package's jit cache key, so the first
        # pass per (bucket, steps) tags as "compile"; the images come back
        # to the host, which fences the device inside the span
        with obs.span("round/generate/sample",
                      key=(bucket, self.sampler_steps), round=round_idx,
                      images=n, bucket=bucket, steps=self.sampler_steps):
            return sample_schedule(self.params, self.ddpm,
                                   gen_round_key(self.seed, round_idx),
                                   labels, self.sampler_steps)


def make_ddpm_generator(dataset: str, num_classes: int, seed: int,
                        sampler_steps: int, obs=None,
                        device="cuda") -> BatchedDDPMGenerator:
    """The runner's `generator="ddpm"` factory: pretrained (cached) params
    on `device` + round-keyed sampling streams. Reads the module-level
    budget constants at call time (tests shrink them via monkeypatch)."""
    params, ddpm = _pretrained_params(dataset, num_classes, RUNNER_TIMESTEPS,
                                      RUNNER_BASE_WIDTH, PRETRAIN_STEPS,
                                      PRETRAIN_REF, PRETRAIN_SEED,
                                      resolve_device(device))
    return BatchedDDPMGenerator(params, ddpm, seed=seed,
                                sampler_steps=sampler_steps, obs=obs)
