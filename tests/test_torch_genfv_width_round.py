"""Round 0 of the GenFV loop at full width (`width_mult=1.0`) in the port
against the JAX package on the CPU, with the data cut to
`train_size=400, test_size=64`: the execution half of
tests/genfv_rounds_harness.py (the reference's plan fed into both
`finish_round`s, both from the reference's initial weights), held to the
harness's tolerances. At this width the round's loss lies far above ln 10
in the reference as in the port: the runner's learning rate makes the
local loss rise within the round (tests/test_torch_genfv_width.py)."""
import genfv_rounds_harness as harness
import numpy as np
import pytest
import torch
from genfv_rounds_harness import JRunConfig, JRunner

from repro_torch.fl.rounds import GenFVRunner, RunConfig
from repro_torch.tree import FlatSpec

KW = dict(width_mult=1.0, rounds=1, train_size=400, test_size=64)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The test runner spreads files over worker processes on the same
    cores; torch's intra-op pool would take every core in each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_round0_full_width_matches_jax():
    ref = JRunner(JRunConfig(**KW))
    port = GenFVRunner(RunConfig(**KW), device="cpu")
    assert port.model_bits == ref.model_bits == 11_173_962 * 32.0
    pj, pt = ref.begin_round(0), port.begin_round(0)
    assert np.array_equal(pj.alpha, pt.alpha) and np.array_equal(pj.parts, pt.parts)
    plan = ref.plan(pj)
    port.server.params = harness._port_params(ref.server.params)
    lj = ref.finish_round(pj, plan)
    lt = port.finish_round(pt, harness._port_plan(plan))
    for f in harness.INT_FIELDS + harness.EXACT_FLOATS:
        assert getattr(lt, f) == getattr(lj, f), f"{f} {getattr(lt, f)} != {getattr(lj, f)}"
    assert lj.selected > 0
    assert abs(lt.loss - lj.loss) <= harness.LOSS_RTOL * abs(lj.loss), \
        f"loss {lt.loss} vs {lj.loss} (rtol {harness.LOSS_RTOL})"
    assert lj.loss > 2 * np.log(10) and lt.loss > 2 * np.log(10), \
        f"round-0 loss: reference {lj.loss}, port {lt.loss}"
    got = FlatSpec(port.server.params).flatten(port.server.params).numpy()
    err = np.abs(got - harness._flat_jax(ref.server.params)).max()
    assert err <= harness.PARAM_TOL, f"params max |delta| {err:.3e} > {harness.PARAM_TOL}"
    assert lt.accuracy == lj.accuracy, f"accuracy {lt.accuracy} vs {lj.accuracy}"
