"""The port's GenFV host layer against the JAX package, bit for bit.

The host layer is numpy code the port keeps its own copy of (configs,
mobility, channel, GPU model, selection, EMD, datasets, partitions, the
vehicular world, the oracle generator, batch sampling and the numpy
SUBP2-4 planner). The same seeds must give equal arrays (`np.array_equal`),
equal floats and equal RNG streams afterwards.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental

# The JAX package imports `jax.experimental.enable_x64`, which jax 0.9
# no longer has; alias it before anything imports `repro`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.configs import genfv_cifar as j_cifar  # noqa: E402
from repro.core import emd as j_emd  # noqa: E402
from repro.core import mobility as j_mob  # noqa: E402
from repro.core import selection as j_sel  # noqa: E402
from repro.core.generation import label_schedule as j_label_schedule  # noqa: E402
from repro.core.two_scale import plan_round as j_plan_round  # noqa: E402
from repro.data.partition import dirichlet_partition as j_partition  # noqa: E402
from repro.data.synthetic import make_image_dataset as j_dataset  # noqa: E402
from repro.fl.fleet import FleetEngine as JFleetEngine  # noqa: E402
from repro.fl.generator import OracleGenerator as JOracle  # noqa: E402
from repro.sim import SCENARIOS as J_SCENARIOS  # noqa: E402
from repro.sim import VehicularWorld as JWorld  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import genfv_cifar as t_cifar  # noqa: E402
from repro_torch.core import emd as t_emd  # noqa: E402
from repro_torch.core import mobility as t_mob  # noqa: E402
from repro_torch.core import selection as t_sel  # noqa: E402
from repro_torch.core.generation import label_schedule  # noqa: E402
from repro_torch.core.two_scale import plan_round  # noqa: E402
from repro_torch.data.partition import dirichlet_partition  # noqa: E402
from repro_torch.data.synthetic import make_image_dataset  # noqa: E402
from repro_torch.fl.fleet import FleetEngine  # noqa: E402
from repro_torch.fl.generator import OracleGenerator  # noqa: E402
from repro_torch.sim import SCENARIOS, VehicularWorld, get_scenario  # noqa: E402

SEEDS = (0, 1, 7)
SCENARIO_NAMES = sorted(J_SCENARIOS)
MODEL_BITS = 11.2e6 * 32


def _rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _same_stream(ra, rb):
    """Both generators are in the same state: their next draws agree."""
    assert np.array_equal(ra.random(4), rb.random(4))


def _same_fleet(fa, fb):
    assert len(fa) == len(fb)
    for va, vb in zip(fa, fb):
        for f in dataclasses.fields(va):
            a, b = getattr(va, f.name), getattr(vb, f.name)
            assert np.array_equal(a, b) and type(a) is type(b), (f.name, a, b)


def _hists_sizes(rng, n=40):
    return rng.dirichlet(np.full(10, 0.3), size=n), rng.integers(500, 2000, size=n)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------
def test_configs_match():
    for name in ("GenFVConfig", "StreamConfig"):
        a, b = getattr(j_base, name)(), getattr(t_base, name)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)], name
    assert j_cifar.DATASETS == t_cifar.DATASETS
    assert j_cifar.EMD_THRESHOLDS == t_cifar.EMD_THRESHOLDS
    for ds in j_cifar.DATASETS:
        assert dataclasses.asdict(j_cifar.cnn_config(ds, 0.5)) == \
            dataclasses.asdict(t_cifar.cnn_config(ds, 0.5))
        assert dataclasses.asdict(j_cifar.genfv_config(ds, 0.3, t_max=2.0)) == \
            dataclasses.asdict(t_cifar.genfv_config(ds, 0.3, t_max=2.0))
    assert sorted(SCENARIOS) == SCENARIO_NAMES
    for name in SCENARIO_NAMES:
        assert dataclasses.asdict(J_SCENARIOS[name]) == \
            dataclasses.asdict(SCENARIOS[name]), name


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dataset", ["cifar10", "cifar100", "gtsrb"])
def test_image_dataset_and_partition(dataset, seed):
    xa, ya = j_dataset(dataset, 120, seed=seed)
    xb, yb = make_image_dataset(dataset, 120, seed=seed)
    assert np.array_equal(xa, xb) and xa.dtype == xb.dtype
    assert np.array_equal(ya, yb) and ya.dtype == yb.dtype
    ra, rb = _rngs(seed)
    pa = j_partition(ya, 12, 0.3, ra)
    pb = dirichlet_partition(yb, 12, 0.3, rb)
    assert len(pa) == len(pb)
    for a, b in zip(pa, pb):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    _same_stream(ra, rb)


# ---------------------------------------------------------------------------
# Mobility, world, EMDs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scenario", SCENARIO_NAMES)
def test_world_fleets_match(scenario, seed):
    ra, rb = _rngs(seed)
    hists, sizes = _hists_sizes(np.random.default_rng(100 + seed))
    cfg_a = J_SCENARIOS[scenario].apply(j_base.GenFVConfig())
    cfg_b = get_scenario(scenario).apply(t_base.GenFVConfig())
    wa = JWorld(cfg_a, J_SCENARIOS[scenario], n_partitions=40, rng=ra)
    wb = VehicularWorld(cfg_b, get_scenario(scenario), n_partitions=40, rng=rb)
    for step in range(4):
        fa, pa = wa.fleet(hists, sizes)
        fb, pb = wb.fleet(hists, sizes)
        _same_fleet(fa, fb)
        assert np.array_equal(pa, pb)
        for f in dataclasses.fields(wa.state):
            assert np.array_equal(getattr(wa.state, f.name),
                                  getattr(wb.state, f.name)), (step, f.name)
        assert dataclasses.asdict(wa.stats) == dataclasses.asdict(wb.stats)
        wa.step(ra, 0.7 + step)
        wb.step(rb, 0.7 + step)
    assert wa.remove([int(wa.state.vid[0])]) == wb.remove([int(wb.state.vid[0])])
    assert wa._free == wb._free
    _same_stream(ra, rb)


@pytest.mark.parametrize("seed", SEEDS)
def test_legacy_fleets_and_emds_match(seed):
    ra, rb = _rngs(seed)
    hists, sizes = _hists_sizes(np.random.default_rng(200 + seed))
    for _ in range(3):
        fa = j_mob.sample_fleet(ra, j_base.GenFVConfig(), hists, sizes)
        fb = t_mob.sample_fleet(rb, t_base.GenFVConfig(), hists, sizes)
        _same_fleet(fa, fb)
    _same_stream(ra, rb)
    labels = np.random.default_rng(seed).integers(0, 10, size=300)
    ha, hb = j_emd.label_histogram(labels, 10), t_emd.label_histogram(labels, 10)
    assert np.array_equal(ha, hb)
    assert j_emd.emd(ha) == t_emd.emd(hb)
    assert np.array_equal(j_emd.emd_many(hists), t_emd.emd_many(hists))
    emds = j_emd.emd_many(hists)[:7]
    assert j_emd.mean_emd(emds) == t_emd.mean_emd(emds)
    assert j_emd.kappas(1.3) == t_emd.kappas(1.3)
    assert np.array_equal(j_emd.data_weights(sizes[:7]), t_emd.data_weights(sizes[:7]))


# ---------------------------------------------------------------------------
# Selection, generation, batch sampling
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scenario", SCENARIO_NAMES + ["legacy"])
def test_selection_policies_match(scenario, seed):
    rng = np.random.default_rng(300 + seed)
    hists, sizes = _hists_sizes(rng)
    if scenario == "legacy":
        cfg_a, cfg_b = j_base.GenFVConfig(), t_base.GenFVConfig()
        fa = j_mob.sample_fleet(np.random.default_rng(seed), cfg_a, hists, sizes)
        fb = t_mob.sample_fleet(np.random.default_rng(seed), cfg_b, hists, sizes)
    else:
        cfg_a = J_SCENARIOS[scenario].apply(j_base.GenFVConfig())
        cfg_b = get_scenario(scenario).apply(t_base.GenFVConfig())
        fa = JWorld(cfg_a, J_SCENARIOS[scenario], 40, np.random.default_rng(seed)).fleet(hists, sizes)[0]
        fb = VehicularWorld(cfg_b, get_scenario(scenario), 40, np.random.default_rng(seed)).fleet(hists, sizes)[0]
    for bits in (MODEL_BITS, MODEL_BITS / 16):
        sa, sb = j_sel.select(cfg_a, fa, bits, 4), t_sel.select(cfg_b, fb, bits, 4)
        for f in ("alpha", "t_bar", "t_cp", "t_mu", "t_hold"):
            assert np.array_equal(getattr(sa, f), getattr(sb, f)), f
        assert sa.reasons == sb.reasons
        assert np.array_equal(j_sel.select_no_emd(cfg_a, fa, bits, 4),
                              t_sel.select_no_emd(cfg_b, fb, bits, 4))
        assert np.array_equal(j_sel.select_madca(cfg_a, fa, bits, 4),
                              t_sel.select_madca(cfg_b, fb, bits, 4))
        for r in (0, 3, 9):
            assert np.array_equal(j_sel.select_ocean(cfg_a, fa, bits, 4, r, 10),
                                  t_sel.select_ocean(cfg_b, fb, bits, 4, r, 10))
        chosen = [i for i in range(len(fa)) if sa.alpha[i]] or [0]
        for t_round in (0.3, 2.0, 30.0):
            assert np.array_equal(j_sel.dropout_mask(cfg_a, fa, chosen, t_round),
                                  t_sel.dropout_mask(cfg_b, fb, chosen, t_round))
    ra, rb = _rngs(seed)
    for k in (1, 5, 12):
        assert np.array_equal(j_sel.select_random(ra, fa, k),
                              t_sel.select_random(rb, fb, k))
    _same_stream(ra, rb)


@pytest.mark.parametrize("seed", SEEDS)
def test_generation_and_sampling_match(seed):
    for b, classes in ((0, 10), (11, 10), (137, 43), (64, 100)):
        assert np.array_equal(j_label_schedule(b, classes), label_schedule(b, classes))
    ra, rb = _rngs(seed)
    for dataset in ("cifar10", "gtsrb"):
        counts = label_schedule(23 + seed, 10)
        labels = np.repeat(np.arange(10), counts)
        ia = JOracle(dataset).generate(labels, ra, round_idx=seed)
        ib = OracleGenerator(dataset).generate(labels, rb, round_idx=seed)
        assert np.array_equal(ia, ib) and ia.dtype == ib.dtype
    assert OracleGenerator("cifar10").generate(np.zeros(0, int), rb).shape == (0, 32, 32, 3)
    imgs, labels = make_image_dataset("cifar10", 50, seed=seed)
    ea = JFleetEngine(j_cifar.cnn_config("cifar10", 0.25), 4, 16, 5e-2)
    eb = FleetEngine(t_cifar.cnn_config("cifar10", 0.25), 4, 16, 5e-2)
    for _ in range(3):
        xa, ya = ea.sample_batches(ra, imgs, labels)
        xb, yb = eb.sample_batches(rb, imgs, labels)
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
    _same_stream(ra, rb)


# ---------------------------------------------------------------------------
# The numpy planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scenario", SCENARIO_NAMES + ["legacy"])
def test_numpy_plan_round_matches(scenario):
    """Three-round plan chains with b_prev threaded as the runner does: the
    port's numpy planner gives the JAX package's numpy plan bit for bit."""
    rng = np.random.default_rng(7)
    hists, sizes = _hists_sizes(rng)
    if scenario == "legacy":
        cfg_a, cfg_b = j_base.GenFVConfig(), t_base.GenFVConfig()
        fleets = [(j_mob.sample_fleet(np.random.default_rng(s), cfg_a, hists, sizes),
                   t_mob.sample_fleet(np.random.default_rng(s), cfg_b, hists, sizes))
                  for s in range(3)]
    else:
        cfg_a = J_SCENARIOS[scenario].apply(j_base.GenFVConfig())
        cfg_b = get_scenario(scenario).apply(t_base.GenFVConfig())
        wa = JWorld(cfg_a, J_SCENARIOS[scenario], 40, np.random.default_rng(1))
        wb = VehicularWorld(cfg_b, get_scenario(scenario), 40, np.random.default_rng(1))
        fleets = []
        for _ in range(3):
            fleets.append((wa.fleet(hists, sizes)[0], wb.fleet(hists, sizes)[0]))
            wa.step(np.random.default_rng(2), 2.0)
            wb.step(np.random.default_rng(2), 2.0)
    b_prev = 0
    for fa, fb in fleets:
        for bits in (MODEL_BITS, MODEL_BITS / 16):
            pa = j_plan_round(cfg_a, fa, bits, 4, b_prev=b_prev, planner="numpy")
            pb = plan_round(cfg_b, fb, bits, 4, b_prev=b_prev, planner="numpy")
            for f in ("alpha", "l", "phi", "t_cp", "t_mu", "e_total"):
                assert np.array_equal(getattr(pa, f), getattr(pb, f)), f
            for f in ("selected", "b_gen", "t_bar", "t_rsu", "bcd_iters",
                      "converged", "history"):
                assert getattr(pa, f) == getattr(pb, f), f
        b_prev = pa.b_gen


def test_genfv_modules_import_with_jax_blocked():
    """The GenFV slice, chip_smoke.py, profile_genfv.py and profile_spans.py
    import neither JAX nor the JAX package."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.fl, repro_torch.fl.rounds, repro_torch.core, repro_torch.sim\n"
        "import repro_torch.data, repro_torch.models.cnn, repro_torch.convert\n"
        "import repro_torch.configs.genfv_cifar, repro_torch.obs\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "import chip_smoke, profile_genfv, profile_spans\n"
        "print('imported')\n")
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and "imported" in res.stdout, res.stderr
