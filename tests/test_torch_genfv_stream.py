"""The port's streaming RSU (`repro_torch.fl.stream.StreamEngine`) against
the JAX package's, and the reference's streaming contracts held inside the
port, on the CPU.

* Against the JAX package: the five churn pairs of
  `benchmarks/bench_stream.py` (`HEADLINE + EXTRA`) under its `STREAM`
  policy at its quick size, `planner="numpy"` in both packages, from the
  reference's initial weights (`convert.from_jax_cnn_params`). Both engines
  step round by round and each port round starts from the reference's
  round-start parameters, as `genfv_rounds_harness` does; the in-flight
  updates each engine queues are its own. Every `StreamLog` field, every
  integer `RoundLog` field and t_bar and t_round are equal: the schedule is
  host-driven and does not depend on the parameters. The loss and the
  parameters after each round are held to the harness's float32
  tolerances (`PARAM_TOL`, `LOSS_RTOL`), the accuracy to one test image
  (`ACC_TOL`).
* Inside the port, bitwise: a fault-free full-quorum stream equals
  `train()`, replay, mid-stream golden resume, the loaders' refusals, no
  stall under any fault preset, the unstreamable configurations refused,
  and the stream ledger reaching `Obs`.
"""
import functools
import os
import sys

import genfv_rounds_harness as harness  # first: aliases enable_x64
import numpy as np
import pytest
import torch

# the churn pairs and the policy come from the benchmark itself, which
# lives at the repository root
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks.bench_stream import EXTRA, HEADLINE, STREAM  # noqa: E402
from repro.configs.base import GenFVConfig as JGenFVConfig  # noqa: E402
from repro.configs.base import StreamConfig as JStreamConfig  # noqa: E402
from repro.fl.rounds import GenFVRunner as JRunner  # noqa: E402
from repro.fl.rounds import RunConfig as JRunConfig  # noqa: E402
from repro.fl.stream import StreamEngine as JStreamEngine  # noqa: E402
from repro.obs import VirtualClock as JVirtualClock  # noqa: E402
from repro_torch.configs.base import GenFVConfig, StreamConfig  # noqa: E402
from repro_torch.fl.faults import fault_names  # noqa: E402
from repro_torch.fl.rounds import GenFVRunner, RunConfig  # noqa: E402
from repro_torch.fl.stream import StreamEngine  # noqa: E402
from repro_torch.obs import Obs, VirtualClock  # noqa: E402
from repro_torch.tree import FlatSpec  # noqa: E402

QUICK = dict(rounds=3, train_size=300, test_size=32, width_mult=0.0625)
FAST5 = dict(QUICK, rounds=5)
CFG = dict(batch_size=8, local_steps=2, num_vehicles=6)
FAST_CFG = GenFVConfig(**CFG)
CHURN = dict(quorum=0.6, cadence_s=0.1, retry_budget=2)
PAIRS = HEADLINE + EXTRA
INT_FIELDS = harness.INT_FIELDS
EXACT_FLOATS = ("t_bar", "t_round")
ACC_TOL = 1 / QUICK["test_size"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The test runner spreads files over worker processes on the same
    cores; torch's intra-op pool would take every core in each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _flat(params):
    return FlatSpec(params).flatten(params)


def _stream(run, sc=None, **kw):
    runner = GenFVRunner(run, FAST_CFG, device="cpu", **kw)
    return runner, StreamEngine(runner, sc)


# ---------------------------------------------------------------------------
# Against the JAX package: the churn pairs of benchmarks/bench_stream.py
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def stream_both(scenario, fault):
    """Both engines over QUICK['rounds'] rounds (module docstring). Returns
    ([(reference log, port log, reference params, port params)], reference
    StreamLogs, port StreamLogs); cached, so the tests of a pair share it."""
    kw = dict(strategy="genfv", scenario=scenario, seed=0, faults=fault,
              planner="numpy", **QUICK)
    ref = JRunner(JRunConfig(**kw), fl_cfg=JGenFVConfig(**CFG))
    port = GenFVRunner(RunConfig(**kw), fl_cfg=GenFVConfig(**CFG), device="cpu")
    ej = JStreamEngine(ref, JStreamConfig(**STREAM))
    et = StreamEngine(port, StreamConfig(**STREAM))
    rounds = []
    for t in range(QUICK["rounds"]):
        port.server.params = harness._port_params(ref.server.params)
        lj, lt = ej.run_round(t), et.run_round(t)
        rounds.append((lj, lt, harness._flat_jax(ref.server.params),
                       _flat(port.server.params).numpy()))
    return rounds, list(ej.slogs), list(et.slogs)


@pytest.fixture(scope="module", params=PAIRS, ids=[f"{s}+{f}" for s, f in PAIRS])
def pair(request):
    return request.param, stream_both(*request.param)


def test_stream_ledgers_equal_the_jax_engine(pair):
    (scenario, fault), (rounds, sj, st) = pair
    assert [vars(s) for s in st] == [vars(s) for s in sj], f"{scenario}+{fault}"
    for lj, lt, _, _ in rounds:
        for f in INT_FIELDS + EXACT_FLOATS:
            assert getattr(lt, f) == getattr(lj, f), \
                f"{scenario}+{fault} round {lj.round}: {f} {getattr(lt, f)} != {getattr(lj, f)}"


def test_stream_loss_and_params_within_float32(pair):
    (scenario, fault), (rounds, _, _) = pair
    for lj, lt, want, got in rounds:
        what = f"{scenario}+{fault} round {lj.round}"
        assert abs(lt.loss - lj.loss) <= harness.LOSS_RTOL * abs(lj.loss), \
            f"{what}: loss {lt.loss} vs {lj.loss} (rtol {harness.LOSS_RTOL})"
        err = np.abs(got - want).max()
        assert err <= harness.PARAM_TOL, \
            f"{what}: params max |delta| {err:.3e} > {harness.PARAM_TOL}"
        # parameters within PARAM_TOL can flip the argmax of a near-tie
        # test image: one image of the 32
        assert abs(lt.accuracy - lj.accuracy) <= ACC_TOL, \
            f"{what}: accuracy {lt.accuracy} vs {lj.accuracy} (tol {ACC_TOL})"


def test_engine_uses_the_clock_it_is_given():
    """StreamEngine(clock=): both engines on one churn pair, each given a
    virtual clock already at 100 s; the port's ledgers equal the JAX
    engine's, start at the clock's time, and the engine's time is that
    clock's."""
    scenario, fault = PAIRS[0]
    kw = dict(strategy="genfv", scenario=scenario, seed=0, faults=fault,
              planner="numpy", **dict(QUICK, rounds=2))
    ref = JRunner(JRunConfig(**kw), fl_cfg=JGenFVConfig(**CFG))
    port = GenFVRunner(RunConfig(**kw), fl_cfg=GenFVConfig(**CFG), device="cpu")
    jclock, clock = JVirtualClock(100.0), VirtualClock(100.0)
    ej = JStreamEngine(ref, JStreamConfig(**STREAM), clock=jclock)
    et = StreamEngine(port, StreamConfig(**STREAM), clock=clock)
    assert et.clock is clock
    for t in range(2):
        port.server.params = harness._port_params(ref.server.params)
        ej.run_round(t)
        et.run_round(t)
    assert [vars(s) for s in et.slogs] == [vars(s) for s in ej.slogs]
    assert et.slogs[0].t_start == 100.0
    assert et.now == clock() == jclock() > et.slogs[-1].t_start

def test_churn_pairs_exercise_the_stream_machinery():
    """The pairs above reach retries, an exhausted budget, a degraded rung,
    late uploads and in-flight merges (the ledgers are equal, so these are
    the reference's counts too)."""
    slogs = [s for p in PAIRS for s in stream_both(*p)[2]]
    assert sum(s.retries for s in slogs) > 0
    assert sum(s.exhausted for s in slogs) > 0
    assert any(s.rung > 0 for s in slogs)
    assert sum(s.late for s in slogs) > 0
    assert sum(s.merged_inflight + s.gap_merged for s in slogs) > 0


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------
def test_clean_full_quorum_is_bitwise_sync():
    run = RunConfig(seed=0, **QUICK)
    sync = GenFVRunner(run, FAST_CFG, device="cpu")
    res_sync = sync.train()
    runner, eng = _stream(run)          # defaults: quorum=1.0, cadence=0
    res_stream = eng.run()
    assert res_sync.logs == res_stream.logs
    assert torch.equal(_flat(sync.server.params), _flat(runner.server.params))
    assert all(s.rung == 0 for s in eng.slogs)
    for s, l in zip(eng.slogs, res_sync.logs):
        assert s.t_commit - s.t_start == pytest.approx(l.t_round)


def _churn_run(planner):
    run = RunConfig(seed=0, planner=planner, faults="rush_hour_deep_fade", **FAST5)
    runner, eng = _stream(run, StreamConfig(**CHURN))
    return runner, eng, eng.run()


@pytest.mark.parametrize("planner", ["torch", "numpy"])
def test_streaming_replay_determinism(planner):
    r1, e1, res1 = _churn_run(planner)
    r2, e2, res2 = _churn_run(planner)
    assert res1.logs == res2.logs
    assert e1.slogs == e2.slogs
    assert [(f.due, f.seq, f.vid) for f in e1.inflight] == \
        [(f.due, f.seq, f.vid) for f in e2.inflight]
    assert torch.equal(_flat(r1.server.params), _flat(r2.server.params))
    assert sum(s.retries for s in e1.slogs) > 0
    assert sum(s.merged_inflight + s.gap_merged for s in e1.slogs) > 0


def test_midstream_checkpoint_resume_golden(tmp_path):
    run = RunConfig(seed=0, faults="rush_hour_deep_fade", **FAST5)
    sc = StreamConfig(**CHURN)
    r_full, e_full = _stream(run, sc)
    res_full = e_full.run()

    r_head, e_head = _stream(run, sc)
    for t in range(3):
        e_head.run_round(t)
    assert e_head.inflight          # the checkpoint carries live uploads
    path = e_head.save_checkpoint(str(tmp_path / "stream_ck"))

    r_res, e_res = _stream(run, sc)
    assert e_res.load_checkpoint(path) == 3
    assert e_res.now == e_head.now
    assert [(f.due, f.seq, f.vid, f.round) for f in e_res.inflight] == \
        [(f.due, f.seq, f.vid, f.round) for f in e_head.inflight]
    for a, b in zip(e_res.inflight, e_head.inflight):
        assert torch.equal(_flat(a.params), _flat(b.params))
    res_res = e_res.run()
    assert res_full.logs == res_res.logs
    assert e_full.slogs == e_res.slogs
    assert torch.equal(_flat(r_full.server.params), _flat(r_res.server.params))


def test_checkpoint_loader_cross_refusal(tmp_path):
    run = RunConfig(seed=0, **QUICK)
    r1, e1 = _stream(run)
    e1.run_round(0)
    spath = e1.save_checkpoint(str(tmp_path / "s"))
    with pytest.raises(ValueError, match="streaming engine"):
        GenFVRunner(run, FAST_CFG, device="cpu").load_checkpoint(spath)
    r3 = GenFVRunner(run, FAST_CFG, device="cpu")
    r3.run_round(0)
    kpath = r3.save_checkpoint(str(tmp_path / "k"))
    _, e4 = _stream(run)
    with pytest.raises(ValueError, match="synchronous runner"):
        e4.load_checkpoint(kpath)
    _, e5 = _stream(run, StreamConfig(quorum=0.5))
    with pytest.raises(ValueError, match="different streaming policy"):
        e5.load_checkpoint(spath)


@pytest.mark.parametrize("preset", sorted(fault_names()))
def test_no_stall_under_any_preset(preset):
    run = RunConfig(seed=0, faults=preset, planner="numpy", **QUICK)
    runner, eng = _stream(run, StreamConfig(quorum=0.6, retry_budget=1))
    res = eng.run()
    assert len(res.logs) == QUICK["rounds"]
    starts = [s.t_start for s in eng.slogs]
    assert all(b > a for a, b in zip(starts, starts[1:]))
    assert eng.now > starts[-1]
    for s in eng.slogs:
        assert 0 <= s.rung <= 3
        assert s.t_commit >= s.t_start
        assert s.arrived >= (1 if s.rung in (0, 1, 2) and s.quorum_target else 0)


def test_engine_rejects_unstreamable_configs():
    with pytest.raises(ValueError, match="vectorized"):
        _stream(RunConfig(vectorized=False, **QUICK))
    with pytest.raises(ValueError, match="aigc_only"):
        _stream(RunConfig(strategy="aigc_only", **QUICK))


def test_stream_ledger_reaches_obs():
    obs = Obs(clock=VirtualClock())
    run = RunConfig(seed=0, faults="rush_hour_deep_fade", obs=obs, **QUICK)
    runner, eng = _stream(run, StreamConfig(quorum=0.6))
    eng.run()
    m = obs.metrics
    assert m.counter_value("stream/rounds") == QUICK["rounds"]
    assert m.counter_value("stream/retries") == sum(s.retries for s in eng.slogs)
    assert m.gauge_value("stream/inflight") == len(eng.inflight)
    names = {e["name"] for e in obs.events}
    assert {"stream/tick", "stream/retry", "stream/commit"} <= names
    assert obs.open_spans == 0

