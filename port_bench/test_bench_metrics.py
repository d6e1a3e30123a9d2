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
PEAK = 67e12


def rnd(ms, selected, syncs, aug, profiled=False, wall=None):
    return {"ms": ms, "selected": selected, "syncs": syncs, "profiled": profiled,
            "fleet_images": selected * 4 * 64, "aug_images": aug, "eval_images": 10000,
            "wall_ms": wall if wall is not None else sum(ms.values())}


TRACE = {
    "rounds": [
        rnd({"round/fleet": 1.0, "round/select": 0.5, "round/plan": 400.0,
             "round/generate": 300.0, "round/local_sgd": 8.0, "round/aggregate": 500.0,
             "round/world_step": 0.5, "round/eval": 340.0}, 10, 50, 1024),
        rnd({"round/fleet": 3.0, "round/select": 0.5, "round/plan": 600.0,
             "round/generate": 200.0, "round/local_sgd": 6.0, "round/aggregate": 300.0,
             "round/world_step": 0.5, "round/eval": 340.0}, 6, 70, 1024),
        # a profiled round: its spans are left out of the span means
        rnd({"round/plan": 5000.0, "round/aggregate": 5000.0}, 8, 60, 1024, profiled=True),
    ],
    "profile": {"busy_s": 3.0, "window_s": 5.0},
    "flops": {"forward": F, "train": FB}, "peak_flops": PEAK,
}

EXPECT = {
    "host_ms": (10.0 + 10.0) / 2, "plan_ms": 500.0, "plan_syncs": 60.0,
    "generate_ms": 250.0, "fleet_step_ms": 400.0, "eval_ms": 340.0,
    "fleet_mfu": 100 * 16 * 256 * FB / 0.8 / PEAK,
    "round_mfu": 100 * ((16 * 256 + 2048) * FB + 20000 * F)
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
    assert got is None or (name == "plan_syncs" and got == 0)


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
