"""`GenFVRunner(RunConfig(generator="ddpm"))` of the port on the CPU: the
counterparts of the JAX package's runner-integration tests
(tests/test_gen.py, "runner integration") and the run held to the JAX
runner.

Both packages' dataplanes are shrunk as the JAX package's tests shrink
theirs (`TINY_BUDGET`: an 8-step noise schedule, base width 8, 2
pretraining steps on 64 images) and each reads a calibration pre-seeded in
its own file (`torch_gen_calib.json`, `gen_calib.json`) with t_image 0.05,
so eq. 48's b* stays at the oracle's scale and no wall-clock measurement
enters a test.

Against the JAX runner (numpy planner in both, so both plan alike):
* with the port's own generator (its own pretraining and noise streams),
  every integer RoundLog field and t_bar equal round by round;
* with the JAX package's pretrained parameters converted into the port's
  generator and the JAX package's per-image noise injected, each round
  started from the reference's round-start weights (tests/
  genfv_rounds_harness.py's execution half): the integer fields and t_bar
  equal, the generated pool within POOL_TOL, the loss and the parameters
  within the harness's LOSS_RTOL and PARAM_TOL.
"""
import functools

import jax
import jax.experimental

# The JAX package imports `jax.experimental.enable_x64`, which jax 0.9
# no longer has; alias it before anything imports `repro`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import genfv_rounds_harness as harness  # noqa: E402
import repro.gen.calib as j_calib  # noqa: E402
import repro.gen.sampler as j_sampler  # noqa: E402
import repro.gen.service as j_service  # noqa: E402
from repro.configs.base import GenFVConfig as JGenFVConfig  # noqa: E402
from repro.diffusion.ddpm import DDPM as JDDPM  # noqa: E402
from repro.fl.rounds import GenFVRunner as JRunner  # noqa: E402
from repro.fl.rounds import RunConfig as JRunConfig  # noqa: E402
import repro_torch.gen.service as gen_service  # noqa: E402
from repro_torch.configs.base import GenFVConfig  # noqa: E402
from repro_torch.convert import from_jax_unet_params  # noqa: E402
from repro_torch.diffusion.ddpm import DDPM  # noqa: E402
from repro_torch.fl.generator import OracleGenerator  # noqa: E402
from repro_torch.fl.rounds import GenFVRunner, RunConfig  # noqa: E402
from repro_torch.gen.calib import (CALIB_BUCKET, MeasuredService,  # noqa: E402
                                   _calib_key, save_calibration)
from repro_torch.gen.service import (BatchedDDPMGenerator,  # noqa: E402
                                     make_ddpm_generator)
from repro_torch.tree import FlatSpec, tree_leaves  # noqa: E402

TINY_BUDGET = dict(RUNNER_TIMESTEPS=8, RUNNER_BASE_WIDTH=8, PRETRAIN_STEPS=2,
                   PRETRAIN_REF=64)
TINY = DDPM(timesteps=8, num_classes=10, base_width=8)
FAST = dict(rounds=3, train_size=300, test_size=32, width_mult=0.0625)
FAST_CFG = dict(batch_size=8, local_steps=2, num_vehicles=6)
STEPS = 2
T_IMAGE = 0.05
POOL_TOL = 1e-5       # generated images in [-1, 1], float32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The test runner spreads files over worker processes on the same
    cores; torch's intra-op pool would take every core in each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def seed_calibrations(t_image=T_IMAGE):
    """Pre-seed both packages' calibration files (under REPRO_ARTIFACTS)
    for the tiny service on the CPU."""
    save_calibration({_calib_key(TINY, STEPS, CALIB_BUCKET, torch.device("cpu")): {
        "t_image": t_image, "bucket": CALIB_BUCKET, "sampler_steps": STEPS}})
    jddpm = JDDPM(timesteps=TINY.timesteps, num_classes=10, base_width=TINY.base_width)
    j_calib.save_calibration({j_calib._calib_key(jddpm, STEPS, CALIB_BUCKET): {
        "t_image": t_image, "bucket": CALIB_BUCKET, "sampler_steps": STEPS}})


@pytest.fixture(autouse=True, scope="module")
def tiny_service(tmp_path_factory):
    """The shrunk dataplane of both packages for the whole module, with the
    calibrations pre-seeded in a module directory."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in TINY_BUDGET.items():
            mp.setattr(gen_service, k, v)
            mp.setattr(j_service, k, v)
        mp.setenv("REPRO_ARTIFACTS", str(tmp_path_factory.mktemp("artifacts")))
        seed_calibrations()
        yield


def _run(**over):
    kw = dict(strategy="genfv", seed=0, generator="ddpm", sampler_steps=STEPS, **FAST)
    kw.update(over)
    return RunConfig(**kw)


def _runner(run, **kw):
    return GenFVRunner(run, fl_cfg=GenFVConfig(**FAST_CFG), device="cpu", **kw)


def _flat(params):
    return FlatSpec(params).flatten(params)


def test_ddpm_runner_end_to_end_one_dispatch_per_round(monkeypatch):
    calls = []
    real = gen_service.sample_schedule
    monkeypatch.setattr(gen_service, "sample_schedule",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    runner = _runner(_run())
    assert isinstance(runner.server.generator, BatchedDDPMGenerator)
    assert isinstance(runner.svc, MeasuredService)
    assert runner.svc.t_per_image == T_IMAGE          # the pre-seeded calibration
    assert all(x.device.type == "cpu" for x in tree_leaves(runner.server.generator.params))
    res = runner.train()
    assert len(res.logs) == FAST["rounds"]
    gen_rounds = sum(1 for log in res.logs if log.b_gen > 0)
    assert gen_rounds > 0
    assert len(calls) == gen_rounds                   # one sampling pass per round
    assert len(runner.server.pool_labels) == sum(log.b_gen for log in res.logs)
    assert all(np.isfinite(log.loss) and 0.0 <= log.accuracy <= 1.0 for log in res.logs)


def test_oracle_runner_has_no_measured_service():
    runner = _runner(RunConfig(**FAST))
    assert runner.svc is None
    assert isinstance(runner.server.generator, OracleGenerator)
    svc = MeasuredService(t_image=0.2, steps=STEPS)
    injected = _runner(RunConfig(**FAST), svc=svc,
                       generator=OracleGenerator("cifar10", fine_frac=0.1))
    assert injected.svc is svc and injected.server.generator.fine_frac == 0.1
    assert injected._checkpoint_state()["gen"] == {"t_image": 0.2, "steps": STEPS}
    assert runner._checkpoint_state()["gen"] == {}


def test_ddpm_runner_golden_resume_bitwise(monkeypatch, tmp_path):
    """Stop after round 0 and resume from the checkpoint in a fresh runner:
    the remaining rounds replay bitwise, with eq. 48 priced against the
    recorded t0 (a poisoned calibration file on the resuming host must not
    perturb the replanned rounds)."""
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path / "artifacts"))
    seed_calibrations()
    run = _run()
    ck = str(tmp_path / "runner.npz")
    golden_runner = _runner(run)
    golden = golden_runner.train()
    first = _runner(run)
    first.run_round(0)
    first.save_checkpoint(ck)
    seed_calibrations(t_image=0.9)
    resumed = _runner(run)
    assert resumed.svc.t_per_image == 0.9
    assert resumed.load_checkpoint(ck) == 1
    assert resumed.svc == MeasuredService(t_image=T_IMAGE, steps=STEPS)
    res = resumed.train()
    assert [vars(a) for a in res.logs] == [vars(g) for g in golden.logs]
    assert torch.equal(_flat(resumed.server.params), _flat(golden_runner.server.params))
    assert np.array_equal(resumed.server.pool_imgs, golden_runner.server.pool_imgs)
    # a runner priced at 0.9 s an image plans other rounds
    assert [log.b_gen for log in _runner(run).train().logs] != [log.b_gen for log in golden.logs]


def test_ddpm_generator_factory_is_deterministic():
    g1 = make_ddpm_generator("cifar10", 10, seed=0, sampler_steps=STEPS, device="cpu")
    g2 = make_ddpm_generator("cifar10", 10, seed=0, sampler_steps=STEPS, device="cpu")
    assert g1.params is g2.params                     # in-process lru share
    assert g1.ddpm == TINY
    labels = np.array([0, 5, 9])
    rng = np.random.default_rng(0)
    a = g1.generate(labels, rng, round_idx=2)
    assert np.array_equal(a, g2.generate(labels, rng, round_idx=2))
    gen_service._pretrained_params.cache_clear()
    g3 = make_ddpm_generator("cifar10", 10, seed=0, sampler_steps=STEPS, device="cpu")
    assert g3.params is not g1.params                 # pretrained again, bitwise
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(g3.params), tree_leaves(g1.params)))
    assert np.array_equal(a, g3.generate(labels, rng, round_idx=2))


# ---------------------------------------------------------------------------
# against the JAX runner
# ---------------------------------------------------------------------------
KW = dict(planner="numpy", **FAST)


@functools.lru_cache(maxsize=None)
def jax_run():
    """The JAX runner's ddpm run round by round: (logs, the parameters at
    each round's start and after the last round, the pool after each round,
    pretrained UNet params, seed)."""
    ref = JRunner(JRunConfig(generator="ddpm", sampler_steps=STEPS, **KW),
                  fl_cfg=JGenFVConfig(**FAST_CFG))
    assert ref.svc.t_per_image == T_IMAGE
    logs, starts, pools = [], [], []
    for t in range(FAST["rounds"]):
        starts.append(jax.tree.map(np.asarray, ref.server.params))
        logs.append(ref.run_round(t))
        pools.append(np.array(ref.server.pool_imgs))
    starts.append(jax.tree.map(np.asarray, ref.server.params))
    return logs, starts, pools, ref.server.generator.params, ref.run.seed


def _check_ledger(jlogs, logs):
    for lj, lt in zip(jlogs, logs, strict=True):
        for f in harness.INT_FIELDS + ("t_bar",):
            assert getattr(lt, f) == getattr(lj, f), \
                f"round {lj.round}: {f} {getattr(lt, f)} != {getattr(lj, f)}"


def test_ddpm_runner_ledger_matches_jax():
    """The port's own generator (own pretraining, own noise): the planner
    does not read the images, so the integer ledger and t_bar equal the
    JAX runner's round by round."""
    jlogs = jax_run()[0]
    assert sum(log.b_gen for log in jlogs) > 0
    runner = _runner(_run(planner="numpy"))
    _check_ledger(jlogs, runner.train().logs)


def _inject_jax_noise(monkeypatch):
    """Route the port's sampler through the JAX package's per-image draws
    of the same (seed, round)."""
    real = gen_service.sample_schedule
    draw = jax.jit(j_sampler._per_image_noise, static_argnums=3)

    def sample(params, ddpm, key, labels, steps, **kw):
        seed, round_idx, _ = key.entropy
        jkey = j_service.gen_round_key(seed, round_idx)
        idx = jax.numpy.arange(len(labels), dtype=jax.numpy.uint32)
        noise = np.stack([np.asarray(draw(jkey, idx, jax.numpy.int32(tag), (32, 32, 3)))
                          for tag in range(steps + 1)], axis=1)
        return real(params, ddpm, key, labels, steps, noise=noise, **kw)
    monkeypatch.setattr(gen_service, "sample_schedule", sample)


def test_ddpm_runner_matches_jax_with_reference_params_and_noise(monkeypatch):
    jlogs, starts, pools, unet, seed = jax_run()
    _inject_jax_noise(monkeypatch)
    gen = BatchedDDPMGenerator(from_jax_unet_params(unet, device="cpu"), TINY, seed=seed,
                               sampler_steps=STEPS)
    port = _runner(_run(planner="numpy"), generator=gen)
    for t in range(FAST["rounds"]):
        port.server.params = harness._port_params(starts[t])
        log = port.run_round(t)
        _check_ledger(jlogs[t:t + 1], [log])
        assert np.abs(port.server.pool_imgs - pools[t]).max() <= POOL_TOL
        assert abs(log.loss - jlogs[t].loss) <= harness.LOSS_RTOL * abs(jlogs[t].loss), \
            f"round {t}: loss {log.loss} vs {jlogs[t].loss}"
        err = np.abs(_flat(port.server.params).numpy() - harness._flat_jax(starts[t + 1])).max()
        assert err <= harness.PARAM_TOL, f"round {t}: params {err:.3e}"
