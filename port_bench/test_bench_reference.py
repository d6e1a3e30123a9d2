"""The reference's pieces against the program's on the CPU: the plan, the
oracle's images, the partition, the model's forward pass. The whole round
is `test_bench_faults.py::test_sound_path_is_correct`."""
import numpy as np
import pytest
import torch

from port_bench.reference import data as D
from port_bench.reference import model as M
from port_bench.reference import solvers as S
from port_bench.spec import constants, load_cell


def test_oracle_and_partition_are_the_programs():
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.fl.generator import OracleGenerator
    labels = np.repeat(np.arange(43), 3)
    a = OracleGenerator("gtsrb").generate(labels, np.random.default_rng(3))
    b = D.oracle_images("gtsrb", labels, np.random.default_rng(3))
    assert np.array_equal(a, b)
    y = np.random.default_rng(1).integers(0, 10, 2000)
    pa = dirichlet_partition(y, 12, 0.1, np.random.default_rng(7))
    pb = D.dirichlet_partition(y, 12, 0.1, np.random.default_rng(7))
    assert all(np.array_equal(u, v) for u, v in zip(pa, pb))


@pytest.mark.parametrize("workload", ["cifar10.genfv-highway", "cifar10.fedavg-highway"])
def test_plan_is_the_numpy_planners(workload):
    """SUBP1 and SUBP2-4 equal the program's numpy planner bit for bit on
    fleets of the cell's world."""
    import dataclasses

    from repro_torch.configs.base import GenFVConfig
    from repro_torch.core.selection import select
    from repro_torch.core.two_scale import plan_round
    from repro_torch.sim import VehicularWorld, get_scenario
    cell = load_cell(workload)
    c = constants(cell["config"], cell["traffic"])
    fields = {f.name for f in dataclasses.fields(GenFVConfig)}
    cfg = GenFVConfig(**{k: v for k, v in c.items() if k in fields})
    rng = np.random.default_rng(5)
    hists = [np.bincount(rng.integers(0, 10, 50), minlength=10) / 50 for _ in range(40)]
    sizes = [int(x) for x in rng.integers(20, 2000, 40)]
    world = VehicularWorld(cfg, get_scenario(cell["traffic"]["scenario"]), 40, rng)
    bits = 32.0 * 11_173_962
    for step in range(4):
        world.step(rng, cfg.t_max)
        fleet, parts = world.fleet(hists, sizes)
        ref_fleet = [dict(x=v.x, v=v.v, phi_max=v.phi_max, f_mem=v.f_mem, f_core=v.f_core,
                          v_core=v.v_core, gain_db=v.gain_db, emd=v.emd, data_size=v.data_size)
                     for v in fleet]
        alpha = select(cfg, fleet, bits, cfg.local_steps).alpha
        assert np.array_equal(alpha, S.select_genfv(c, ref_fleet, bits, cfg.local_steps))
        p = plan_round(cfg, fleet, bits, cfg.local_steps, b_prev=17 * step,
                       alpha_override=alpha, planner="numpy")
        q = S.plan(c, ref_fleet, alpha, bits, cfg.local_steps, 17 * step)
        assert p.selected == q["selected"] and p.b_gen == q["b_gen"]
        assert np.array_equal(p.l, q["l"]) and np.array_equal(p.phi, q["phi"])
        assert p.t_bar == q["t_bar"]


def test_forward_is_the_programs():
    from repro_torch.configs.genfv_cifar import cnn_config
    from repro_torch.models.cnn import cnn_forward
    model = {"stem_width": 64, "width_mult": 0.125, "stage_blocks": [2, 2, 2, 2],
             "channels": 3, "num_classes": 43, "image_size": 32}
    params = M.init_params(model, 9, "cpu")
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    a = cnn_forward(params, cnn_config("gtsrb", 0.125), x)
    torch.testing.assert_close(M.forward(params, x), a, rtol=1e-5, atol=1e-5)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.0 - 2 ** -12])
    assert M._tf32_round(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]


@pytest.mark.parametrize("base", [16, 8])
def test_ddpm_is_the_programs(base):
    """The generator reference's DDPM against the program's sampler at the
    runner's width (base 16) and at the tests' (base 8), 8 strided steps of the 200-step schedule and a
    few labels, on the benchmark's weights: the same tree, the same noise
    bit for bit, the same images to float32 rounding. The tolerance, 1e-5
    of each image's norm, covers eight steps of float32 convolutions and
    the reference's float64 schedule against the program's float32 one
    (they read 6e-7 to 8e-7); TF32 reads 8e-4."""
    from repro_torch.diffusion.ddpm import DDPM
    from repro_torch.diffusion.unet import init_unet
    from repro_torch.gen.sampler import image_noise, sample_schedule, strided_timesteps
    from repro_torch.gen.service import gen_round_key

    from port_bench.check import gen_gap
    from port_bench.spec import load_generator
    ref = load_generator("ddpm")
    block = {"base_width": base, "embed_dim": 256, "timesteps": 200, "beta_min": 1e-4,
             "beta_max": 0.02, "num_classes": 10, "sampler_steps": 8}
    program = init_unet(np.random.default_rng(0), 10, base=base, device="cpu")
    assert {k: tuple(v.shape) for k, v in ref.flat(program).items()} == \
        ref.flat(ref.param_shapes(block))
    assert np.array_equal(ref.strided(200, 8), strided_timesteps(200, 8))
    assert np.array_equal(ref.noise(7, 4, 2, 3, 8), image_noise(gen_round_key(7, 4), 2, 3, 8))
    params = ref.make_params(block, 2 ** 31 + 5, "cpu")
    labels = np.array([0, 3, 3, 9, 5])
    a = sample_schedule(params, DDPM(timesteps=200, num_classes=10, base_width=base),
                        gen_round_key(7, 4), labels, 8)
    b = ref.generate(block, params, labels, None, 7, 4, "cpu")
    assert gen_gap(a, b) < 1e-5
