"""The configuration's generator block, on the CPU at a small size: a run
of the highway cell with the program's DDPM as its generator and its result
line, its check against the program's sampler broken
underneath and against the control and the generator reference's planted
faults, an oracle configuration built and checked as before the block,
and a generator reference found by its name alone."""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench.conftest import DDPM_BLOCK
from port_bench.runcell import run_cell
from port_bench.spec import HERE, ROOT
from port_bench.test_bench_faults import (aug_half_batch, b_gen_plus_one, eval_plus_one,
                                          half_batch, unchanged)

SEED = 4_000_000_321
HIGHWAY = "cifar10.genfv-highway"
CPU = torch.device("cpu")


def ddpm_cell(small):
    """The highway cell with the DDPM block in its configuration."""
    return small(HIGHWAY, generator=DDPM_BLOCK)


def run(cell, trace=False):
    return run_cell(cell, SEED, 0.2, trace, CPU, time.perf_counter(), log=lambda m: None)[0]


# -- faults of the program's sampler, planted underneath ----------------------
def labels_shifted(monkeypatch):
    """The program's sampler draws each image as the next class."""
    from repro_torch.gen import service
    real = service.sample_schedule

    def sample(params, ddpm, key, labels, steps, *a, **k):
        return real(params, ddpm, key, (np.asarray(labels) + 1) % ddpm.num_classes, steps,
                    *a, **k)
    monkeypatch.setattr(service, "sample_schedule", sample)


def other_noise(monkeypatch):
    """Each image of the program's sampler takes the next image's noise."""
    from repro_torch.gen import service
    real = service.sample_schedule

    def sample(params, ddpm, key, labels, steps, *a, **k):
        return real(params, ddpm, key, labels, steps, start=1)
    monkeypatch.setattr(service, "sample_schedule", sample)


def step_skipped(monkeypatch):
    """The program's strided schedule repeats a timestep, so that the step
    at that position leaves the images where they were: one denoising step
    fewer."""
    from repro_torch.gen import sampler
    real = sampler.strided_timesteps

    def strided(timesteps, steps):
        ts = real(timesteps, steps).copy()
        ts[steps // 2] = ts[steps // 2 - 1]
        return ts
    monkeypatch.setattr(sampler, "strided_timesteps", strided)


@pytest.mark.parametrize("fault, caught", [
    (labels_shifted, "gen_gap"), (other_noise, "gen_gap"), (step_skipped, "gen_gap"),
    (unchanged, "agg_gap"), (half_batch, "loss_gap"), (eval_plus_one, "eval_gap"),
    (b_gen_plus_one, "plan_gap"), (aug_half_batch, "aug_loss_gap")],
    ids=lambda f: getattr(f, "__name__", f))
def test_broken_path_is_not_correct(small, monkeypatch, fault, caught):
    cell = ddpm_cell(small)
    fault(monkeypatch)
    line = run(cell)
    assert line["correct"] is False and line["failed"] >= 1
    assert line["check"][caught]["value"] > line["check"][caught]["limit"], line["check"]


@pytest.mark.parametrize("key, value, says", [
    ("kind", "gan", "serves no generator"), ("ch_mult", [1, 2, 2, 2], "takes no key"),
    ("reference", "oracle", "parameter shapes"), ("embed_dim", 128, "parameter shapes")])
def test_program_against_block(small, key, value, says):
    """A block that states another generator than the program can serve is
    refused before any round: another kind, a key the program's DDPM does
    not take, a reference whose parameter tree differs from the program's
    UNet, an embedding width other than the program's."""
    from port_bench.harness import ConfigMismatch, build
    cell = ddpm_cell(small)
    cell["config"]["generator"][key] = value
    with pytest.raises(ConfigMismatch, match=says):
        build(cell, SEED, CPU, False)


def test_program_serves_the_benchmarks_weights(small):
    """The runner's generator is the block's DDPM on the weights the block's
    reference draws from the seed, sampling in the block's steps: the
    program's own pretraining is not run."""
    from port_bench.harness import build
    from port_bench.reference.generators import flat
    from port_bench.spec import generator_block, load_generator
    cell = ddpm_cell(small)
    block = generator_block(cell["config"])
    program = build(cell, SEED, CPU, False)[0].server.generator
    want = flat(load_generator("ddpm").make_params(block, SEED, CPU))
    assert {k: v.tolist() for k, v in flat(program.params).items()} == \
        {k: v.tolist() for k, v in want.items()}
    assert (program.ddpm.base_width, program.ddpm.timesteps, program.sampler_steps) == \
        (block["base_width"], block["timesteps"], block["sampler_steps"])


def test_control_and_planted_faults_fail_gen_gap(small):
    """`control.py` on the DDPM cell: the program passes every limit; the
    control (the reference in TF32, its planner in float32) fails a number,
    and each planted fault of the generator reference (a step left out,
    labels moved by one class, another image's noise) fails gen_gap. On the
    CPU the program reads about 1e-6 and the emulated TF32 about 1e-3."""
    from port_bench import check as chk
    from port_bench.control import readings
    from port_bench.spec import load_generator
    cell = ddpm_cell(small)
    out = readings(cell, SEED, 0.2, CPU, log=lambda m: None)
    limits = cell["limits"]

    def passes(side):
        per_round = {i: r[side] if side in r else r["faults"][side]
                     for i, r in out["picked"].items()}
        return all(v["ok"] for v in chk.judge(chk.worst(per_round, limits), limits).values())
    assert passes("program") and not passes("control")
    faults = load_generator("ddpm").FAULTS
    for f in faults:
        assert not passes(f), f
    gens = out["gens"].values()
    assert max(g["program"] for g in gens) <= limits["gen_gap"]
    assert min(g["control"] for g in gens if g["control"]) > limits["gen_gap"]
    assert all(g[f] > limits["gen_gap"] for g in gens for f in faults if f in g)


@pytest.mark.parametrize("program, want", [
    ("same", 0.0), ("one_image_off", 0.1), ("one_image_more", 1.0), ("none_for_none", 0.0)])
def test_gen_gap(program, want):
    """gen_gap: the largest relative L2 distance over a round's images, 1
    where the program added another count of images than the reference, 0
    where neither added any."""
    from port_bench.check import gen_gap
    rng = np.random.default_rng(3)
    ref = rng.standard_normal((5, 32, 32, 3)).astype(np.float32)
    if program == "same":
        a = ref.copy()
    elif program == "one_image_off":
        a = ref.copy()
        a[2] *= 1.1
    elif program == "one_image_more":
        a = np.concatenate([ref, ref[:1]])
    else:
        a, ref = None, ref[:0]
    assert gen_gap(a, ref) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("trace", [0, 1])
def test_line_shape(small, trace):
    """The line of a cell with the DDPM: its end-to-end metrics, or its
    per-layer ones but those the CPU cannot read, and gen_gap among the
    check's numbers."""
    cell = ddpm_cell(small)
    line = json.loads(json.dumps(run(cell, bool(trace))))
    assert line["correct"] is True and line["failed"] == 0, line["check"]
    names = [m["name"] for m in (cell["per_layer"] if trace else cell["end_to_end"])]
    silent = ("device_idle_share", "fleet_mfu", "round_mfu")
    assert sorted(line["metrics"]) == sorted(n for n in names if n not in silent)
    assert list(line["check"]) == list(cell["limits"]) and "gen_gap" in line["check"]


def test_oracle_cell_builds_and_checks_as_before(small):
    """Without a generator block the runner builds the oracle `fl.generator`
    names and prices eq. 48 itself (no `svc`), and the check's numbers equal
    those of the pool rebuilt as before the block: `oracle_images` from each
    round's stream state, concatenated round by round."""
    from repro_torch.fl.generator import OracleGenerator

    from port_bench import check as chk
    from port_bench.harness import build
    from port_bench.reference.data import oracle_images
    from port_bench.reference.round import run_round
    from port_bench.runcell import measure
    from port_bench.spec import reference_cell
    cell = small(HIGHWAY)
    runner = build(cell, SEED, CPU, False)[0]
    assert runner.svc is None and type(runner.server.generator) is OracleGenerator
    assert runner.run.generator == "oracle" and "sampler_buckets" not in cell["traffic"]

    w = measure(cell, SEED, 0.2, False, CPU, time.perf_counter(), log=lambda m: None)
    rounds, picked = w["rounds"], w["picked"]
    ref = chk.Reference(reference_cell(cell), w["train"], w["test"],
                        cell["traffic"]["world_seed"], CPU, SEED)
    now = chk.check(ref, rounds, picked)

    def oracle(labels, rng):
        return oracle_images(ref.cell["dataset"], labels, rng)

    def pool_before(i):
        px = py = None
        for r in rounds[:i]:
            labels = np.repeat(np.arange(ref.cell["classes"]),
                               chk.label_schedule(int(r["plan"].b_gen), ref.cell["classes"]))
            if not len(labels):
                continue
            rng = np.random.default_rng()
            rng.bit_generator.state = r["rng_generate"]
            imgs = oracle(labels, rng)
            px = imgs if px is None else np.concatenate([px, imgs])
            py = labels.astype(np.int32) if py is None else \
                np.concatenate([py, labels.astype(np.int32)])
        return px, py

    for i in picked:
        r = rounds[i]
        before = run_round(ref.cell, chk.round_state(r), ref.data, pool_before(i), r["p0"],
                           generate=oracle)
        want = chk.numbers(chk.program_output(r, len(ref.test_y)), before, r["p0"],
                           ref.correct(r["p1"]))
        assert {k: v for k, v in now[i].items() if k != "gen_gap"} == want
    assert all(x["gen_gap"] == 0.0 for x in now.values() if "gen_gap" in x)


def test_generator_found_by_name(small, tmp_path):
    """A configuration and a generator reference added as files alone, under
    another root, are found by their names and run: the room a further
    diffusion model needs."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = tmp_path / HERE.name
    for d in ("configs", "traffic", "limits", "reference/generators"):
        (here / d).mkdir(parents=True)
    config = json.loads((HERE / "configs" / "resnet18-cifar10.json").read_text())
    config["name"], config["generator"] = "toy", dict(DDPM_BLOCK, reference="toy")
    (here / "configs" / "toy.json").write_text(json.dumps(config))
    traffic = json.loads((HERE / "traffic" / "genfv-highway.json").read_text())
    (here / "traffic" / "ddpm-highway.json").write_text(
        json.dumps(dict(traffic, name="ddpm-highway", sampler_buckets=[16, 32])))
    limits = json.loads((HERE / "limits" / f"{HIGHWAY}.json").read_text())
    (here / "limits" / "toy.ddpm-highway.json").write_text(
        json.dumps(dict(limits, gen_gap=1e-4)))
    (here / "reference" / "generators" / "toy.py").write_text(
        '"""A throwaway generator reference: the DDPM\'s under another name."""\n'
        "from port_bench.reference.generators.ddpm import *  # noqa: F401,F403\n")
    bench["configs"].append({"name": "toy", "source": "https://arxiv.org/abs/2503.19676",
                             "file": "port_bench/configs/toy.json", "reduced": [],
                             "why": "a throwaway"})
    bench["workloads"].append({"name": "toy.ddpm-highway", "config": "toy",
                               "traffic": "ddpm-highway", "chips": 1, "why": "a throwaway"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = small("toy.ddpm-highway", tmp_path)
    line = run(cell)
    assert line["correct"] is True and "gen_gap" in line["check"], line["check"]
    toy = sys.modules["port_bench.reference.generators.toy"]
    assert Path(toy.__file__).parent == here / "reference" / "generators"
