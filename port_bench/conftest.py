"""Test settings of the benchmark: the `card` marker and a cell cut to a
size the CPU runs in seconds."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: limits of the CPU-sized cells: at width 1/16 a GroupNorm group holds one
#: channel, and float32 rounding grows along the steps far more than at the
#: published widths, whose limits are in limits/; at this size the round's
#: loss is steady and catches the emulated TF32, which the full-size cells
#: leave to the evaluation
SMALL_LIMITS = {"plan_gap": 1e-3, "loss_gap": 1e-5, "agg_gap": 0.05, "aug_gap": 0.5,
                "aug_loss_gap": 1e-4, "eval_gap": 0.0, "gen_gap": 1e-4}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one (run on the chip "
        "with `python3 -m pytest -m card port_bench`)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


#: the program's class-conditional DDPM as its runner serves it (base 16,
#: the paper's 200-step schedule, 50 strided steps), as a configuration's
#: generator block states it: the tests' generator path, of which the
#: benchmark holds no cell until the program serves a DDPM at published
#: widths (PERF.md)
DDPM_BLOCK = {"kind": "ddpm", "reference": "ddpm", "sampler_steps": 50, "base_width": 16,
              "embed_dim": 256, "timesteps": 200, "beta_min": 1e-4, "beta_max": 0.02,
              "num_classes": 10}
#: a generator block cut to a size the CPU samples in seconds
SMALL_BLOCK = {"base_width": 8, "timesteps": 50, "sampler_steps": 4}


def small_cell(workload: str, root: Path = ROOT, generator: dict | None = None) -> dict:
    """The cell with the model at width 1/16, 600 / 96 images, 8 vehicles,
    h 2, B 8 and a short burn-in: the same code paths, sized for the CPU.
    `generator`, a generator block, is put into the configuration; a
    configuration's generator block is cut to SMALL_BLOCK, sampled at
    bucket 4, and its images are checked (gen_gap)."""
    from port_bench.spec import load_cell
    cell = copy.deepcopy(load_cell(workload, root))
    cell["config"]["model"]["width_mult"] = 0.0625
    cell["config"]["dataset"].update(train_size=600, test_size=96)
    cell["config"]["genfv"].update(num_vehicles=8, batch_size=8, local_steps=2)
    cell["traffic"].update(buckets=[4], burn_in_steps=5, checked_rounds=2)
    if generator is not None:
        cell["config"]["generator"] = dict(generator)
    gen = "generator" in cell["config"]
    if gen:
        cell["config"]["generator"].update(SMALL_BLOCK)
        cell["traffic"]["sampler_buckets"] = [4]
    cell["limits"] = {k: v for k, v in SMALL_LIMITS.items()
                      if (not k.startswith("aug") or cell["traffic"]["strategy"] == "genfv")
                      and (k != "gen_gap" or gen)}
    return cell


@pytest.fixture
def small(monkeypatch):
    """small_cell, with the process's check for JAX turned off: a test
    worker also runs the JAX package's tests (the check itself is
    test_bench_imports.py's)."""
    import torch

    from port_bench import runcell
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setattr(runcell, "forbidden_modules", lambda: [])
    yield small_cell
    torch.set_num_threads(threads)
