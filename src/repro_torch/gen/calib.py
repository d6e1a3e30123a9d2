"""Measured per-image generation cost feeding the eq. 12-13 delay terms,
the counterpart of the JAX package's `gen/calib.py`.

With the sampler in the loop the planner prices eq. 48's b* with a
`MeasuredService` whose ``t_per_image`` is the steady-state wall clock per
image of the bucketed sampling pass on this device (host noise draws,
transfers and the denoising loop), not `DiffusionService`'s assumed cycle
model.

Measurements are cached in the port's own ``repro_torch.gen/calib/v1`` JSON
file (``torch_gen_calib.json`` under `artifact_dir()`, REPRO_ARTIFACTS-aware),
keyed per (device type, device name, model shape, sampler_steps, bucket):
two runners on the same host share one calibration, and a
checkpoint-resumed runner restores the *recorded* t0 from the run
checkpoint instead of measuring again — a new measurement would jitter the
planner's inputs and break bitwise resume.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import torch

from repro_torch.diffusion.ddpm import DDPM
from repro_torch.exp.artifacts import artifact_dir
from repro_torch.gen.sampler import sample_schedule
from repro_torch.gen.service import gen_round_key
from repro_torch.obs import host_meta

CALIB_SCHEMA = "repro_torch.gen/calib/v1"
CALIB_FILE = "torch_gen_calib.json"

#: bucket the runner calibrates at — the steady-state schedule size for
#: default fleets (eq.-48 b* across ~8-16 selected vehicles).
CALIB_BUCKET = 16
CALIB_REPEATS = 3


@dataclass(frozen=True)
class MeasuredService:
    """Drop-in for `core.generation.DiffusionService` backed by a measured
    per-image latency. Frozen and hashable, as the assumed service."""
    t_image: float                  # realized seconds per image
    steps: int = 50                 # sampler_steps it was measured at
    source: str = "measured"

    @property
    def t_per_image(self) -> float:
        """t0 in eq. (12)."""
        return self.t_image


def _calib_key(ddpm: DDPM, sampler_steps: int, bucket: int,
               device: torch.device) -> str:
    device = torch.device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    return "/".join(map(str, (device.type, name, ddpm.timesteps,
                              ddpm.num_classes, ddpm.base_width,
                              sampler_steps, bucket)))


def measure_t_per_image(params, ddpm: DDPM, sampler_steps: int,
                        bucket: int = CALIB_BUCKET,
                        repeats: int = CALIB_REPEATS) -> float:
    """Steady-state seconds per image of the bucketed pass: one warmup call
    absorbs the one-time costs (cuDNN's algorithm choice, allocator growth),
    then the best of `repeats` timed calls. Each call ends by copying the
    images to the host, which waits for the device, so the clock reads the
    finished work and not the enqueue."""
    labels = [i % ddpm.num_classes for i in range(bucket)]
    key = gen_round_key(0, 0)
    sample_schedule(params, ddpm, key, labels, sampler_steps)   # warmup
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        sample_schedule(params, ddpm, key, labels, sampler_steps)
        best = min(best, time.perf_counter() - t0)
    return best / bucket


def _calib_path(directory: str | None = None) -> str:
    return os.path.join(artifact_dir(directory), CALIB_FILE)


def load_calibration(directory: str | None = None) -> dict:
    """The calibration table {key: {t_image, bucket, sampler_steps}}; empty
    on a missing or foreign file."""
    path = _calib_path(directory)
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    if doc.get("schema") != CALIB_SCHEMA:
        return {}
    return doc.get("entries", {})


def save_calibration(entries: dict, directory: str | None = None) -> str:
    """Rewrite the calibration file (sorted keys: byte-stable for unchanged
    content)."""
    path = _calib_path(directory)
    doc = {"schema": CALIB_SCHEMA, "host": host_meta(), "entries": entries}
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, indent=1)
        f.write("\n")
    return path


def calibrated_service(params, ddpm: DDPM, sampler_steps: int,
                       bucket: int = CALIB_BUCKET,
                       directory: str | None = None) -> MeasuredService:
    """The measured service of (the parameters' device, ddpm, sampler_steps,
    bucket): a cache hit returns without touching the sampler, a miss
    measures once and persists."""
    key = _calib_key(ddpm, sampler_steps, bucket, params["in"].device)
    entries = load_calibration(directory)
    hit = entries.get(key)
    if hit is not None:
        return MeasuredService(t_image=float(hit["t_image"]),
                               steps=int(sampler_steps))
    t_image = measure_t_per_image(params, ddpm, sampler_steps, bucket)
    entries[key] = {"t_image": t_image, "bucket": int(bucket),
                    "sampler_steps": int(sampler_steps)}
    save_calibration(entries, directory)
    return MeasuredService(t_image=t_image, steps=int(sampler_steps))
