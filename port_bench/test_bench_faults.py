"""The output check fails a run whose timed path is broken underneath, and
`control.py`'s control in the program's place. On the CPU at a small
size."""
import time

import numpy as np
import pytest
import torch

from port_bench.runcell import run_cell

SEED = 4_000_000_123


def run(cell):
    return run_cell(cell, SEED, 0.2, False, torch.device("cpu"), time.perf_counter(),
                    log=lambda m: None)[0]


def unchanged(monkeypatch):
    """The fleet step hands back the state it started from."""
    from repro_torch.fl.server import GenFVServer
    real = GenFVServer.fleet_round

    def fleet_round(self, *a, **k):
        p = self.params
        out = real(self, *a, **k)
        self.params = p
        return (p,) + tuple(out[1:])
    monkeypatch.setattr(GenFVServer, "fleet_round", fleet_round)


def half_batch(monkeypatch):
    """Each SGD step of the fleet step sees half its batch."""
    import repro_torch.fl.fleet as fleet
    real = fleet.sgd_steps_flat

    def sgd(flat, spec, cfg, imgs, labels, h, lr, mu=0.0):
        b = labels.shape[-1] // 2
        return real(flat, spec, cfg, imgs[:, :b], labels[:, :b], h, lr, mu)
    monkeypatch.setattr(fleet, "sgd_steps_flat", sgd)


def eval_plus_one(monkeypatch):
    """The evaluation counts one test image more."""
    from repro_torch.fl.rounds import GenFVRunner
    real = GenFVRunner.evaluate

    def evaluate(self):
        n = len(self.test_labels)
        return float(np.float32(round(real(self) * n) + 1) / np.float32(n))
    monkeypatch.setattr(GenFVRunner, "evaluate", evaluate)


def b_gen_plus_one(monkeypatch):
    """The plan generates one image more than SUBP4 decided."""
    from repro_torch.fl.rounds import GenFVRunner
    real = GenFVRunner.plan

    def plan(self, pending):
        p = real(self, pending)
        p.b_gen += 1
        return p
    monkeypatch.setattr(GenFVRunner, "plan", plan)


def aug_half_batch(monkeypatch):
    """omega_a's steps alone see half their batch; the vehicles train
    right."""
    import repro_torch.fl.client as client
    real = client.local_sgd_steps

    def sgd(params, cfg, imgs, labels, h, lr, prox_mu=0.0):
        b = labels.shape[-1] // 2
        return real(params, cfg, imgs[:, :b], labels[:, :b], h, lr, prox_mu)
    monkeypatch.setattr(client, "local_sgd_steps", sgd)


@pytest.mark.parametrize("fault, caught", [
    (unchanged, "agg_gap"), (half_batch, "loss_gap"), (eval_plus_one, "eval_gap"),
    (b_gen_plus_one, "plan_gap"), (aug_half_batch, "aug_loss_gap")],
    ids=lambda f: getattr(f, "__name__", f))
def test_broken_path_is_not_correct(small, monkeypatch, fault, caught):
    cell = small("cifar10.genfv-highway")
    fault(monkeypatch)
    line = run(cell)
    assert line["correct"] is False and line["failed"] >= 1
    assert line["check"][caught]["value"] > line["check"][caught]["limit"], line["check"]


def test_control_fails_a_number(small):
    """`control.py`'s control, the reference in TF32 with a float32 planner
    in the program's place, is judged not correct; the program on the same
    seed is correct."""
    from port_bench import check as chk
    from port_bench.control import readings
    cell = small("cifar10.genfv-highway")
    out = readings(cell, SEED, 0.2, torch.device("cpu"), log=lambda m: None)
    limits = cell["limits"]
    for side, ok in (("program", True), ("control", False)):
        per_round = {i: r[side] for i, r in out["picked"].items()}
        verdict = chk.judge(chk.worst(per_round, limits), limits)
        assert all(v["ok"] for v in verdict.values()) is ok, (side, verdict)


def test_sound_path_is_correct(small):
    for workload in ("gtsrb.genfv-rush", "cifar10.fedavg-highway"):
        line = run(small(workload))
        assert line["correct"] is True, line["check"]
