"""The program's procedural oracle (`fl/generator.py::OracleGenerator`):
each image the class's pattern, rolled, plus noise, drawn from the round's
stream (`reference/data.py::oracle_images`). No weights, no denoising
steps."""
from __future__ import annotations

from port_bench.reference.data import oracle_images

FAULTS = ()


def param_shapes(block: dict) -> dict:
    return {}


def make_params(block: dict, seed: int, device) -> dict:
    return {}


def generate(block, params, labels, rng, run_seed, round_idx, device, *,
             prec=None, fault=None):
    if fault is not None:
        raise ValueError(f"the oracle plants no fault {fault!r}")
    return oracle_images(block["dataset"], labels, rng)


def step_flops(block: dict) -> float:
    return 0.0
