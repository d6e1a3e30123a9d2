"""The port's GenFV round loop under the five registered fault schedules
against the JAX package's, on the vectorized and the sequential path
(`genfv_rounds_harness.run_faulted`: the reference plans, both runners
execute, each port round from the reference's round-start parameters).
The integer ledger and t_round are equal; loss and parameters are held to
the harness's float32 tolerances."""
import genfv_rounds_harness as harness
import pytest
import torch

SCHEDULES = ("compute_stragglers", "mixed_stress", "platoon_mass_dropout",
             "poison_minority", "rush_hour_deep_fade")
CASES = [(name, vec) for name in SCHEDULES for vec in (True, False)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The test runner spreads files over worker processes on the same
    cores; torch's intra-op pool would take every core in each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=CASES, ids=[f"{n}-{'vec' if v else 'seq'}" for n, v in CASES])
def runs(request):
    return harness.run_faulted(*request.param)


def test_execution_half_ledger_equal(runs):
    harness.check_execution_half_ledger_equal(runs)


def test_execution_half_loss_and_params(runs):
    harness.check_execution_half_loss_and_params(runs)


@pytest.mark.parametrize("vectorized", [True, False])
def test_schedules_exercise_every_recovery_branch(vectorized):
    """The runs above do reach rejection, late buffering, stale merges and
    forced departures (the ledgers are equal, so the port's counts are the
    reference's)."""
    totals = dict.fromkeys(("rejected", "late", "stale_merged", "dropped"), 0)
    for name in SCHEDULES:
        for _, lt, _, _ in harness.run_faulted(name, vectorized)[1]:
            for key in totals:
                totals[key] += getattr(lt, key)
    assert all(v > 0 for v in totals.values()), totals
