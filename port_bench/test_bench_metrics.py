"""The per-layer readers on recorded spans, the FLOP count and the profile
reduction."""
import json
from types import SimpleNamespace

import pytest

from port_bench.flops import forward_flops, train_flops
from port_bench.recorder import busy_ms, gaps, reduce_profile
from port_bench.runcell import read_metric
from port_bench.spec import HERE, ROOT

F, FB = 1.1108e9, 3.3290e9
#: the 16-wide UNet's forward FLOPs an image and denoising step
G = 88_653_824
PEAK = 67e12


def rnd(ms, selected, syncs, aug, profiled=False, wall=None, steps=0, gen_flops=0.0):
    return {"ms": ms, "selected": selected, "syncs": syncs, "profiled": profiled,
            "plan_steps": steps, "fleet_images": selected * 4 * 64, "aug_images": aug,
            "eval_images": 10000, "gen_flops": gen_flops,
            "wall_ms": wall if wall is not None else sum(ms.values())}


#: one round's sampling: 30 images x 50 steps of the 16-wide UNet
GEN = 30 * 50 * G

TRACE = {
    "rounds": [
        rnd({"round/fleet": 1.0, "round/select": 0.5, "round/plan": 400.0,
             "round/plan/bandwidth": 380.0, "round/plan/power": 10.0,
             "round/generate": 300.0, "round/generate/sample": 15.0,
             "round/generate/train": 280.0, "round/local_sgd": 8.0,
             "round/aggregate": 500.0, "round/aggregate/upload": 20.0,
             "round/aggregate/sgd": 470.0, "round/world_step": 0.5,
             "round/eval": 340.0}, 10, 50, 1024, steps=500, gen_flops=GEN),
        # a round that generates nothing opens no sampling span
        rnd({"round/fleet": 3.0, "round/select": 0.5, "round/plan": 600.0,
             "round/plan/bandwidth": 570.0, "round/plan/power": 20.0,
             "round/generate": 200.0, "round/generate/train": 190.0,
             "round/local_sgd": 6.0, "round/aggregate": 300.0,
             "round/aggregate/upload": 10.0, "round/aggregate/sgd": 280.0,
             "round/world_step": 0.5, "round/eval": 340.0}, 6, 70, 1024, steps=300),
        # a profiled round: its spans are left out of the span means
        rnd({"round/plan": 5000.0, "round/aggregate": 5000.0}, 8, 60, 1024, profiled=True,
            steps=400),
    ],
    "profile": {"busy_s": 3.0, "window_s": 5.0},
    "flops": {"forward": F, "train": FB}, "peak_flops": PEAK,
}

EXPECT = {
    "host_ms": (10.0 + 10.0) / 2, "plan_ms": 500.0, "plan_syncs": 60.0,
    "plan_bandwidth_ms": 475.0, "plan_power_ms": 15.0, "plan_steps": 400.0,
    "generate_ms": 250.0, "aug_train_ms": 235.0,
    "fleet_step_ms": 400.0, "fleet_upload_ms": 15.0, "fleet_sgd_ms": 375.0,
    "eval_ms": 340.0,
    "fleet_mfu": 100 * 16 * 256 * FB / 0.8 / PEAK,
    "round_mfu": 100 * ((16 * 256 + 2048) * FB + 20000 * F + GEN)
    / ((sum(TRACE["rounds"][0]["ms"].values()) + sum(TRACE["rounds"][1]["ms"].values())) / 1e3)
    / PEAK,
    "device_idle_share": 40.0,
}


def per_layer_names():
    return [m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]]


@pytest.mark.parametrize("name", per_layer_names())
def test_reader(name):
    assert read_metric(name, TRACE) == pytest.approx(EXPECT[name], rel=1e-12)


@pytest.mark.parametrize("name", per_layer_names())
def test_reader_without_data_is_silent(name):
    empty = {"rounds": [rnd({}, 0, 0, 0, profiled=True)], "profile": {},
             "flops": TRACE["flops"], "peak_flops": None}
    got = read_metric(name, empty)
    # a count of the planner's work reads 0 where rounds ran but counted none
    assert got is None or (name in ("plan_syncs", "plan_steps") and got == 0)


def test_every_metric_has_a_reader():
    assert sorted(p.stem for p in (HERE / "metrics").glob("[a-z]*.py")) == sorted(per_layer_names())


@pytest.mark.parametrize("config, classes", [("resnet18-cifar10", 10), ("resnet18-gtsrb", 43)])
def test_flops_pinned(config, classes):
    model = json.loads((HERE / "configs" / f"{config}.json").read_text())["model"]
    assert forward_flops(model) == pytest.approx(F, rel=1e-3)
    assert train_flops(model) == pytest.approx(FB, rel=1e-3)


def test_flops_match_the_flop_counter():
    """The count from the shapes equals torch.utils.flop_counter's on the
    reference model, forward and forward plus backward."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench.reference import model as M
    model = {"stem_width": 64, "width_mult": 0.25, "stage_blocks": [2, 2, 2, 2],
             "channels": 3, "num_classes": 43, "image_size": 32}
    params = M.init_params(model, 0, "cpu")
    x, y = torch.randn(2, 3, 32, 32), torch.tensor([1, 2])
    with FlopCounterMode(display=False) as fwd:
        M.forward(params, x)
    ps = [p.requires_grad_(True) for p in M.leaves(params)]
    with FlopCounterMode(display=False) as both:
        torch.autograd.grad(M.loss(M.rebuild(params, ps), x, y), ps)
    assert fwd.get_total_flops() == 2 * forward_flops(model)
    assert both.get_total_flops() == 2 * train_flops(model)


def test_generator_flops_pinned():
    """One image's denoising step of the program's DDPM as its runner serves
    it (base 16), and the oracle's none."""
    from port_bench.conftest import DDPM_BLOCK
    from port_bench.spec import load_generator
    block = DDPM_BLOCK
    assert load_generator(block["reference"]).step_flops(block) == G
    assert load_generator("oracle").step_flops(block) == 0.0


@pytest.mark.parametrize("base", [8, 16, 24])
def test_generator_flops_match_the_flop_counter(base):
    """The UNet's count from its widths equals torch.utils.flop_counter's on
    the reference's forward pass."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench.spec import load_generator
    ddpm = load_generator("ddpm")
    block = {"base_width": base, "embed_dim": 64, "num_classes": 10}
    params = ddpm.make_params(block, 0, "cpu")
    with FlopCounterMode(display=False) as count:
        ddpm.unet(params, torch.zeros(2, 3, 32, 32), torch.tensor([3, 9]), torch.tensor([1, 2]))
    assert count.get_total_flops() == 2 * ddpm.step_flops(block)


def test_busy_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (50, 55)]
    assert busy_ms(iv) == pytest.approx(35 / 1e3)
    assert busy_ms(iv, 8, 35) == pytest.approx((20 - 8 + 35 - 30) / 1e3)
    assert gaps(iv, 0, 60) == [(20, 30), (40, 50), (55, 60)]


def test_reduce_profile():
    """Clocks tied by the marker kernel; gaps named by the innermost span."""
    def ev(s, e, name):
        return SimpleNamespace(time_range=SimpleNamespace(start=s, end=e), name=name,
                               device_type=__import__("torch").autograd.DeviceType.CUDA)
    # the device clock runs 1000 us ahead of the host's
    events = [ev(1000, 1001, "spin_kernel"), ev(1100, 1300, "conv"), ev(1500, 1600, "gemm")]
    prof = SimpleNamespace(events=lambda: events)
    host = [("round", 100e-6, 700e-6), ("round/plan", 300e-6, 500e-6)]
    out = reduce_profile(prof, host, 0.0)
    assert out["window_s"] == pytest.approx(600e-6)
    assert out["busy_s"] == pytest.approx(300e-6)
    assert dict(out["idle_gaps"]) == pytest.approx({"round/plan": 200e-6,
                                                    "between spans": 100e-6})
    assert dict(out["device_ops"]) == pytest.approx({"conv": 200e-6, "gemm": 100e-6})
