"""Shared harness of tests/test_torch_genfv_rounds.py (genfv) and
tests/test_torch_genfv_baselines.py (fedprox, aigc_only): the port's
synchronous GenFV round loop against the JAX package's, at
`RunConfig(rounds=2, train_size=400, test_size=64)` (width 0.25), on the
CPU.

* Execution half: both runners run `begin_round`; the JAX package plans
  (`planner="jax"`) and its `RoundPlan` is fed, converted, into both
  `finish_round`s, so the execution is held regardless of planner drift.
  Each port round starts from the reference's round-start parameters
  (carried over with `convert.from_jax_cnn_params`, the way the first
  round's initial weights are), so a round's error does not compound into
  the next. Every integer `RoundLog` field and t_bar, kappa2, emd_bar and
  t_round are equal; the loss and the global parameters after each round
  are held to the float32 tolerances below.
* Whole loop: `train()` with the port's own planner (`"torch"`), from the
  same initial weights; selected, b_gen and bcd_iters equal the reference's
  at seed 0.

The float32 tolerances cover amplification, not a loose port: a round
trains omega_a for 16 SGD steps at lr 5e-2 on the few generated images
(b_gen = 11 here) and each vehicle for 4 steps, and along that trajectory
a relative change of 1e-7 in the starting weights grows by three orders
of magnitude or more (`test_torch_genfv_baselines.py::
test_float32_amplification` measures it and bounds the packages'
difference by it).
"""
import dataclasses
import functools

import jax
import jax.experimental

# The JAX package imports `jax.experimental.enable_x64`, which jax 0.9
# no longer has; alias it before anything imports `repro`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.fl.rounds import GenFVRunner as JRunner  # noqa: E402
from repro.fl.rounds import RunConfig as JRunConfig  # noqa: E402
from repro_torch.convert import from_jax_cnn_params  # noqa: E402
from repro_torch.core.planner import RoundPlan  # noqa: E402
from repro_torch.fl.rounds import GenFVRunner, RunConfig  # noqa: E402
from repro_torch.tree import FlatSpec, tree_leaves  # noqa: E402

KW = dict(rounds=2, train_size=400, test_size=64)
INT_FIELDS = ("round", "selected", "b_gen", "dropped", "late", "rejected",
              "stale_merged", "stale_dropped", "bcd_iters", "planner_converged")
EXACT_FLOATS = ("t_bar", "kappa2", "emd_bar", "t_round")
PARAM_TOL = 2e-2      # max |delta| of the global parameters after a round
LOSS_RTOL = 2e-3      # the round's loss, relative


def _port_params(tree):
    return from_jax_cnn_params(jax.tree.map(np.asarray, tree), device="cpu")


def _flat_jax(tree):
    return np.concatenate([
        (np.asarray(x).transpose(3, 2, 0, 1) if np.ndim(x) == 4 else np.asarray(x)).ravel()
        for x in jax.tree.leaves(tree)])


def _port_plan(plan):
    return RoundPlan(**{f.name: getattr(plan, f.name)
                        for f in dataclasses.fields(plan)})


@functools.lru_cache(maxsize=None)
def run_both(strategy):
    """Both runners through KW['rounds'] rounds (see the module docstring).
    Returns (strategy, [(reference log, port log, reference params, port
    params) per round], the whole-loop port logs, that runner, the initial
    weights); cached, so the tests of one strategy share one run."""
    ref = JRunner(JRunConfig(strategy=strategy, **KW))
    port = GenFVRunner(RunConfig(strategy=strategy, **KW), device="cpu")
    init = _port_params(ref.server.params)
    rounds = []
    for t in range(KW["rounds"]):
        pj, pt = ref.begin_round(t), port.begin_round(t)
        assert np.array_equal(pj.alpha, pt.alpha) and np.array_equal(pj.parts, pt.parts)
        plan = ref.plan(pj)
        port.server.params = _port_params(ref.server.params)
        lj = ref.finish_round(pj, plan)
        lt = port.finish_round(pt, _port_plan(plan))
        rounds.append((lj, lt, _flat_jax(ref.server.params),
                       FlatSpec(port.server.params).flatten(port.server.params).numpy()))
    whole = GenFVRunner(RunConfig(strategy=strategy, **KW), device="cpu")
    whole.server.params = init
    return strategy, rounds, whole.train().logs, whole, init


def check_execution_half_ledger_equal(runs):
    strategy, rounds = runs[:2]
    for lj, lt, _, _ in rounds:
        for f in INT_FIELDS + EXACT_FLOATS:
            assert getattr(lt, f) == getattr(lj, f), \
                f"{strategy} round {lj.round}: {f} {getattr(lt, f)} != {getattr(lj, f)}"
        assert 0.0 <= lt.accuracy <= 1.0


def check_execution_half_loss_and_params(runs):
    strategy, rounds = runs[:2]
    for lj, lt, want, got in rounds:
        assert abs(lt.loss - lj.loss) <= LOSS_RTOL * abs(lj.loss), \
            f"{strategy} round {lj.round}: loss {lt.loss} vs {lj.loss} (rtol {LOSS_RTOL})"
        err = np.abs(got - want).max()
        assert err <= PARAM_TOL, \
            f"{strategy} round {lj.round}: params max |delta| {err:.3e} > {PARAM_TOL}"


def check_whole_loop_matches(runs):
    """The port's own planner in the loop: selected, b_gen and bcd_iters
    equal the reference's at seed 0. A b_gen off by one would be within the
    planner contract (DESIGN.md), and is reported here, not hidden."""
    strategy, rounds, logs, runner = runs[:4]
    assert len(logs) == len(rounds)
    for (lj, _, _, _), lw in zip(rounds, logs):
        what = f"{strategy} round {lj.round}"
        assert lw.selected == lj.selected, f"{what}: selected {lw.selected} != {lj.selected}"
        assert lw.bcd_iters == lj.bcd_iters, f"{what}: bcd_iters {lw.bcd_iters} != {lj.bcd_iters}"
        assert lw.b_gen == lj.b_gen, \
            f"{what}: b_gen {lw.b_gen} != {lj.b_gen} (contract allows +/-1: " \
            f"{'within' if abs(lw.b_gen - lj.b_gen) <= 1 else 'outside'} it)"
        assert np.isfinite(lw.loss) and 0.0 <= lw.accuracy <= 1.0
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(runner.server.params))
