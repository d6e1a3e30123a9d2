"""The port's GenFV round loop against the JAX package's for the baseline
strategies fedprox (random selection, the FedProx term) and aigc_only
(omega_a alone). The harness and its tolerances:
tests/genfv_rounds_harness.py."""
import genfv_rounds_harness as harness
import numpy as np
import pytest
import torch

from repro_torch.fl.rounds import GenFVRunner, RunConfig
from repro_torch.tree import FlatSpec, tree_map


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The test runner spreads files over worker processes on the same
    cores; torch's intra-op pool would take every core in each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["fedprox", "aigc_only"])
def runs(request):
    return harness.run_both(request.param)


def test_execution_half_ledger_equal(runs):
    harness.check_execution_half_ledger_equal(runs)


def test_execution_half_loss_and_params(runs):
    harness.check_execution_half_loss_and_params(runs)


def test_whole_loop_matches(runs):
    harness.check_whole_loop_matches(runs)


def test_float32_amplification():
    """The tolerance's premise, measured on the port alone: one aigc_only
    round (16 SGD steps on omega_a) from the same weights and from weights
    moved by a relative 1e-7 ends at least 1e-4 apart, and the port's
    difference from the JAX package in that round is within 10 times that."""
    strategy, rounds, _, _, init = harness.run_both("aigc_only")
    ends = []
    for eps in (0.0, 1e-7):
        runner = GenFVRunner(RunConfig(strategy=strategy, **dict(harness.KW, rounds=1)),
                             device="cpu")
        gen = torch.Generator().manual_seed(5)
        runner.server.params = tree_map(
            lambda x: x * (1 + eps * torch.randn(x.shape, generator=gen)), init)
        runner.train()
        ends.append(FlatSpec(runner.server.params).flatten(runner.server.params).numpy())
    sensitivity = np.abs(ends[0] - ends[1]).max()
    _, _, want, got = rounds[0]
    diff = np.abs(got - want).max()
    assert sensitivity >= 1e-4, f"a 1e-7 change moved the round by only {sensitivity:.3e}"
    assert diff <= 10 * sensitivity, f"port vs JAX {diff:.3e} > 10 x {sensitivity:.3e}"
