"""The port's experiment layer (`repro_torch.exp`) on the CPU: spec
validation and expansion against the JAX package's, cross-process spec
determinism, the JAX planner name refused, sweep == per-cell bitwise on
both port planners and for ddpm cells (grouped by their measured
service), rerun and `stop_after` resume bitwise, the artifact
store, Theorem 1 (`convergence`, `lambda_bound`, `theorem1_comparison`,
`optimal_kappa2`) bitwise against the JAX package on the same inputs, and
the `torch_scenario_sweep` example."""
import dataclasses
import json
import os
import subprocess
import sys

import genfv_rounds_harness  # noqa: F401  (first: aliases enable_x64)
import numpy as np
import pytest
import torch

from repro.core import convergence as j_conv
from repro.core.emd import lambda_bound as j_lambda_bound
from repro.exp import ExperimentSpec as JExperimentSpec
from repro.exp import optimal_kappa2 as j_optimal_kappa2
from repro.exp import theorem1_comparison as j_theorem1_comparison
from repro.exp.sweep import SweepResult as JSweepResult
from repro.fl.rounds import RunConfig as JRunConfig
from repro_torch.configs.base import GenFVConfig
from repro_torch.core import convergence
from repro_torch.core.emd import lambda_bound
from repro_torch.exp import (ExperimentSpec, Sweep, SweepResult, grid,
                             optimal_kappa2, theorem1_comparison)
from repro_torch.fl.rounds import GenFVRunner, RunConfig, run_payload

REPO_ROOT = os.path.join(os.path.dirname(__file__), "..")
FAST = dict(rounds=2, train_size=300, test_size=32, width_mult=0.0625)
FAST_CFG = GenFVConfig(batch_size=8, local_steps=2, num_vehicles=6)
PARITY_KEYS = ("loss", "accuracy", "t_bar", "selected", "dropped", "b_gen",
               "kappa2", "emd_bar", "bcd_iters")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The test runner spreads files over worker processes on the same
    cores; torch's intra-op pool would take every core in each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _sweep(spec, **kw):
    return Sweep(spec, fl_cfg=FAST_CFG, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------
def test_spec_validates_eagerly():
    with pytest.raises(ValueError, match="unknown strategy"):
        ExperimentSpec(strategies=("sgd",))
    with pytest.raises(ValueError, match="unknown scenario"):
        ExperimentSpec(scenarios=("autobahn",))
    with pytest.raises(ValueError, match="unknown planner"):
        ExperimentSpec(overrides=({"planner": "xla"},))
    with pytest.raises(ValueError, match="unknown RunConfig field"):
        ExperimentSpec(overrides=({"lr": 1.0},))
    with pytest.raises(ValueError, match="collides with a grid axis"):
        ExperimentSpec(overrides=({"strategy": "genfv"},))
    with pytest.raises(ValueError, match="axis .* is empty"):
        ExperimentSpec(seeds=())


def test_jax_planner_name_refused_naming_torch():
    """A JAX payload's planner "jax" is refused, never mapped: the error
    names the port's device planner."""
    with pytest.raises(ValueError, match="'jax'.*'torch'"):
        RunConfig(planner="jax")
    with pytest.raises(ValueError, match="'jax'.*'torch'"):
        ExperimentSpec(overrides=({"planner": "jax"},))
    payload = JExperimentSpec(name="ref", base=JRunConfig(**FAST)).to_payload()
    payload["schema"] = "repro_torch.exp/spec/v1"
    assert payload["base"]["planner"] == "jax"
    with pytest.raises(ValueError, match="'jax'.*'torch'"):
        ExperimentSpec.from_payload(payload)


def test_expand_order_and_coords_equal_the_jax_spec():
    axes = dict(strategies=("genfv", "fedavg"), scenarios=("rush_hour", "legacy"),
                alphas=(0.1, 1.0), seeds=(0, 1), sampler_steps=(10, 50))
    ours = ExperimentSpec(base=RunConfig(**FAST), overrides=({}, {"planner": "numpy"}),
                          **axes).expand()
    ref = JExperimentSpec(base=JRunConfig(**FAST), overrides=({}, {"planner": "numpy"}),
                          **axes).expand()
    assert len(ours) == len(ref) == 64
    for a, b in zip(ours, ref):
        assert a.coords() == b.coords()
        pa, pb = run_payload(a.run), dict(b.run.__dict__)
        pb.pop("obs")
        want_planner = {"jax": "torch", "numpy": "numpy"}[pb.pop("planner")]
        assert pa.pop("planner") == want_planner
        assert pa == pb


def test_spec_json_roundtrip_and_grid():
    spec = ExperimentSpec(name="rt", strategies=("genfv", "fl_only"), alphas=(0.1, 1.0),
                          base=RunConfig(**FAST), overrides=({"model_bits": 1e6},))
    again = ExperimentSpec.from_json(spec.to_json())
    assert again == spec and again.to_json() == spec.to_json()
    assert spec.to_payload()["schema"] == "repro_torch.exp/spec/v1"
    assert grid(a=(1, 2), b=("x", "y", "z"))[:3] == [
        {"a": 1, "b": "x"}, {"a": 1, "b": "y"}, {"a": 1, "b": "z"}]
    assert grid() == [{}]


def test_spec_to_json_byte_identical_across_processes():
    prog = (
        "from repro_torch.fl.rounds import RunConfig\n"
        "from repro_torch.exp import ExperimentSpec\n"
        "s = ExperimentSpec(name='determinism',"
        " strategies=('genfv','fedavg','fl_only'),"
        " scenarios=('rush_hour','sparse_rural'), alphas=(0.1, 0.3),"
        " seeds=(0, 1, 2), base=RunConfig(rounds=3, train_size=128),"
        " overrides=({}, {'planner': 'numpy', 'model_bits': 32.0}))\n"
        "import sys; sys.stdout.write(s.to_json())\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    outs = []
    for seed in ("0", "1"):
        env["PYTHONHASHSEED"] = seed
        r = subprocess.run([sys.executable, "-c", prog], env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(r.stdout)
    assert outs[0] == outs[1]
    json.loads(outs[0])


def test_sweep_entry_point_needs_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Sweep(ExperimentSpec(base=RunConfig(**FAST)))


# ---------------------------------------------------------------------------
# Sweep == per-cell
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("planner", ["torch", "numpy"])
def test_sweep_matches_single_runs_bitwise(planner):
    """A 2x2 strategy x scenario grid through Sweep.run() reproduces the
    cells run one by one through GenFVRunner, bitwise: the torch planner
    batches each round's cells of one scenario into one dispatch, numpy
    plans per cell on the host."""
    spec = ExperimentSpec(name=f"parity_{planner}", strategies=("genfv", "fedavg"),
                          scenarios=("rush_hour", "highway_free_flow"),
                          base=RunConfig(planner=planner, **FAST))
    result = _sweep(spec).run()
    if planner == "torch":
        # 2 scenarios -> 2 planning groups of 2 fleets, per round
        assert result.meta["planner_dispatches"] == 2 * FAST["rounds"]
        assert result.meta["planner_batched_fleets"] == 4 * FAST["rounds"]
        assert result.meta["planner_largest_batch"] == 2
    else:
        assert result.meta["planner_dispatches"] == 0
    assert result.meta["dataset_builds"] == 2      # train + eval, shared
    assert result.meta["dataset_cache_hits"] == 2 * (spec.n_cells - 1)
    assert result.meta["engines"] == 1
    for cell in spec.expand():
        single = GenFVRunner(cell.run, fl_cfg=FAST_CFG, device="cpu").train()
        for key in PARITY_KEYS:
            np.testing.assert_array_equal(result.metrics[key][cell.index], single.curve(key),
                                          err_msg=f"{cell.strategy}/{cell.scenario}/{key}")


def test_sweep_rerun_and_stop_after_resume_bitwise(tmp_path):
    spec = ExperimentSpec(name="resume", strategies=("genfv", "fl_only"),
                          scenarios=("urban_stop_go",), base=RunConfig(**FAST))
    a = _sweep(spec).run()
    b = _sweep(spec).run()
    assert a.to_json() == b.to_json()
    ck = str(tmp_path / "sweep_ck")
    head = _sweep(spec).run(checkpoint_dir=ck, stop_after=1)
    assert list(head.rounds) == [1, 1]
    resumed = _sweep(spec).run(checkpoint_dir=ck)
    assert list(resumed.rounds) == [2, 2]
    for key in a.metrics:
        np.testing.assert_array_equal(resumed.metrics[key], a.metrics[key], err_msg=key)
    other = ExperimentSpec(name="other", strategies=("genfv",), base=RunConfig(**FAST))
    with pytest.raises(ValueError, match="different ExperimentSpec"):
        _sweep(other).run(checkpoint_dir=ck)


def test_ddpm_sweep_groups_by_measured_service(monkeypatch, tmp_path):
    """`generator="ddpm"` cells on the sampler_steps axis: each runner
    builds its own DDPM service (the tiny dataplane of
    tests/test_torch_genfv_ddpm_rounds.py, t_image pre-seeded per steps), so
    cells with different measured services never share a planner dispatch,
    and the sweep still equals each cell run alone, bitwise."""
    import repro_torch.gen.service as gen_service
    from repro_torch.diffusion.ddpm import DDPM
    from repro_torch.gen.calib import (CALIB_BUCKET, MeasuredService, _calib_key,
                                       save_calibration)
    for k, v in dict(RUNNER_TIMESTEPS=8, RUNNER_BASE_WIDTH=8, PRETRAIN_STEPS=2,
                     PRETRAIN_REF=64).items():
        monkeypatch.setattr(gen_service, k, v)
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    tiny = DDPM(timesteps=8, num_classes=10, base_width=8)
    save_calibration({_calib_key(tiny, steps, CALIB_BUCKET, torch.device("cpu")): {
        "t_image": t, "bucket": CALIB_BUCKET, "sampler_steps": steps}
        for steps, t in ((2, 0.05), (4, 0.08))})
    spec = ExperimentSpec(name="ddpm", sampler_steps=(2, 4),
                          base=RunConfig(generator="ddpm", **FAST))
    result = _sweep(spec).run()
    assert result.meta["planner_dispatches"] == 2 * FAST["rounds"]
    assert result.meta["planner_largest_batch"] == 1
    for cell in spec.expand():
        single = GenFVRunner(cell.run, fl_cfg=FAST_CFG, device="cpu")
        assert single.svc == MeasuredService(t_image={2: 0.05, 4: 0.08}[cell.sampler_steps],
                                             steps=cell.sampler_steps)
        res = single.train()
        for key in PARITY_KEYS:
            np.testing.assert_array_equal(result.metrics[key][cell.index], res.curve(key),
                                          err_msg=f"sampler_steps {cell.sampler_steps}/{key}")


@pytest.fixture(scope="module")
def small_result():
    spec = ExperimentSpec(name="small", strategies=("genfv", "fl_only"),
                          scenarios=("rush_hour", "platoon"), base=RunConfig(**FAST))
    return _sweep(spec).run()


def test_sweep_artifact_roundtrip_and_wrong_kind(small_result, tmp_path):
    path = small_result.save(directory=str(tmp_path))
    assert path.endswith("small.sweep.json")
    doc = json.load(open(path))
    assert doc["schema"] == "repro_torch.exp/sweep/v1"
    assert doc["spec"]["schema"] == "repro_torch.exp/spec/v1"
    loaded = SweepResult.load(path)
    assert loaded.to_json() == small_result.to_json()
    sub = small_result.select(strategy="fl_only")
    assert len(sub.cells) == 2
    np.testing.assert_array_equal(sub.metrics["loss"][0],
                                  small_result.curve("loss", strategy="fl_only",
                                                     scenario="rush_hour"))
    with pytest.raises(KeyError, match="matches 4 cells"):
        small_result.curve("accuracy")
    bogus = tmp_path / "bogus.sweep.json"
    bogus.write_text(json.dumps({"schema": "repro_torch.exp/theorem1/v1"}))
    with pytest.raises(ValueError, match="expected kind"):
        SweepResult.load(str(bogus))
    jax_doc = tmp_path / "ref.sweep.json"
    jax_doc.write_text(json.dumps({"schema": "repro.exp/sweep/v1"}))
    with pytest.raises(ValueError, match="not a repro_torch.exp artifact"):
        SweepResult.load(str(jax_doc))


# ---------------------------------------------------------------------------
# Theorem 1 against the JAX package
# ---------------------------------------------------------------------------
def test_convergence_and_lambda_bound_bitwise():
    rng = np.random.default_rng(0)
    for _ in range(20):
        kw = dict(beta=float(rng.uniform(0.5, 2)), varrho=float(rng.uniform(5, 20)),
                  mu=float(rng.uniform(0.1, 1)), h=int(rng.integers(1, 8)),
                  sigma=float(rng.uniform(0, 0.5)), lambda_a=float(rng.uniform(0, 0.2)),
                  theta=float(rng.uniform(0.5, 3)))
        kw["eta"] = float(rng.uniform(0.1, 0.9)) / kw["varrho"]
        p, jp = convergence.ConvergenceParams(**kw), j_conv.ConvergenceParams(**kw)
        n = int(rng.integers(1, 12))
        rhos, lams = rng.dirichlet(np.ones(n)), rng.uniform(0, 1, n)
        k2 = float(rng.uniform(0, 1))
        assert convergence.chi(p) == j_conv.chi(jp)
        assert convergence.psi(p) == j_conv.psi(jp)
        assert convergence.big_lambda(p, rhos, lams, 1 - k2, k2) == \
            j_conv.big_lambda(jp, rhos, lams, 1 - k2, k2)
        T = int(rng.integers(0, 30))
        assert convergence.bound(p, T, rhos, lams, 1 - k2, k2) == \
            j_conv.bound(jp, T, rhos, lams, 1 - k2, k2)
        assert np.array_equal(convergence.bound_curve(p, T, rhos, lams, 1 - k2, k2),
                              j_conv.bound_curve(jp, T, rhos, lams, 1 - k2, k2))
        assert optimal_kappa2(p, T, rhos, lams) == j_optimal_kappa2(jp, T, rhos, lams)
        e, g = float(rng.uniform(0, 2)), float(rng.uniform(0, 1))
        assert lambda_bound(e, g) == j_lambda_bound(e, g)
    with pytest.raises(ValueError, match="eta < 1/varrho"):
        convergence.bound(convergence.ConvergenceParams(eta=0.5), 1, [1.0], [0.1], 1.0, 0.0)


def test_theorem1_comparison_equals_the_jax_function(small_result, tmp_path):
    """The same round logs (the port's sweep) through both packages'
    `theorem1_comparison`: every row, the L* proxy and the per-scenario
    table are equal, bitwise."""
    res = small_result
    ours = theorem1_comparison(res)
    ref = j_theorem1_comparison(JSweepResult(None, res.cells, res.rounds, res.metrics,
                                             dict(res.meta)))
    assert ours.loss_star == ref.loss_star and ours.params == ref.params
    assert [dataclasses.asdict(r) for r in ours.rows] == \
        [dataclasses.asdict(r) for r in ref.rows]
    assert ours.per_scenario() == ref.per_scenario()
    assert ours.to_markdown() == ref.to_markdown()
    assert [r["scenario"] for r in ours.per_scenario()] == ["platoon", "rush_hour"]
    for row in ours.rows:
        assert row.h == FAST_CFG.local_steps and len(row.bound_curve) == FAST["rounds"]
        assert np.isfinite(row.bound_final) and row.bound_final > 0
    path = ours.save("t1", directory=str(tmp_path))
    doc = json.load(open(path))
    assert doc["schema"] == "repro_torch.exp/theorem1/v1"
    assert len(doc["rows"]) == 4 and doc["per_scenario"]


# ---------------------------------------------------------------------------
# The example
# ---------------------------------------------------------------------------
def test_torch_scenario_sweep_example_quick(tmp_path):
    env = dict(os.environ, REPRO_ARTIFACTS=str(tmp_path))
    r = subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "examples", "torch_scenario_sweep.py"),
         "--rounds", "1", "--scenarios", "rush_hour,sparse_rural", "--device", "cpu",
         "--save"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "2 scenarios on cpu" in r.stdout
    assert "rush_hour" in r.stdout and "sparse_rural" in r.stdout
    saved = SweepResult.load(str(tmp_path / "torch_scenario_sweep.sweep.json"))
    assert list(saved.rounds) == [1, 1]
