"""The port's GenFV round loop against the JAX package's for the strategy
genfv (the main path), plus the runner's defaults and its one unported
path (the DDPM generator).
The harness and its tolerances: tests/genfv_rounds_harness.py."""
import dataclasses

import genfv_rounds_harness as harness
import pytest
import torch
from genfv_rounds_harness import JRunConfig, JRunner

from repro_torch.fl.rounds import GenFVRunner, RunConfig
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The test runner spreads files over worker processes on the same
    cores; torch's intra-op pool would take every core in each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["genfv"])
def runs(request):
    return harness.run_both(request.param)


def test_execution_half_ledger_equal(runs):
    harness.check_execution_half_ledger_equal(runs)


def test_execution_half_loss_and_params(runs):
    harness.check_execution_half_loss_and_params(runs)


def test_whole_loop_matches(runs):
    harness.check_whole_loop_matches(runs)


def test_runner_defaults_and_unported_paths(tmp_path):
    kw = harness.KW
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            GenFVRunner(RunConfig(**kw))
    with pytest.raises(ValueError, match="unknown planner"):
        RunConfig(planner="jax")
    assert RunConfig().planner == "torch"
    with pytest.raises(ValueError, match="unknown fault schedule"):
        RunConfig(faults="platoon_dropout")
    for extra in (dict(faults="platoon_mass_dropout"), dict(vectorized=False)):
        GenFVRunner(RunConfig(**kw, **extra), device="cpu")
    # generator="ddpm" runs since the AIGC dataplane was ported
    # (tests/test_torch_genfv_ddpm_rounds.py); its fields are validated
    with pytest.raises(ValueError, match="unknown generator"):
        RunConfig(generator="gan")
    with pytest.raises(ValueError, match="sampler_steps"):
        RunConfig(sampler_steps=0)
    runner = GenFVRunner(RunConfig(**dict(kw, rounds=0)), device="cpu")
    assert runner.train(checkpoint_path=str(tmp_path / "ckpt")).logs == []
    assert (tmp_path / "ckpt.npz").exists() is False
    ref = JRunner(JRunConfig(**dict(kw, rounds=0)))
    n = sum(x.numel() for x in tree_leaves(runner.server.params))
    assert runner.model_bits == ref.model_bits == n * 32.0
    assert all(x.device.type == "cpu" for x in tree_leaves(runner.server.params))
    want = {f.name: f.default for f in dataclasses.fields(JRunConfig)}
    got = {f.name: f.default for f in dataclasses.fields(RunConfig)}
    assert want.pop("planner") == "jax" and got.pop("planner") == "torch"
    assert got == want
