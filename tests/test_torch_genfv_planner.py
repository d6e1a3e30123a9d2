"""The port's device planner (`planner="torch"`, float64) against the JAX
package's `planner="jax"`, on the CPU.

Held to DESIGN.md §"The numpy-reference contract": alpha bitwise; l, phi,
t_mu and t_bar within atol 1e-3 (= bcd_eps); b_gen within 1; and, beyond
the contract, the same number of BCD iterations. Within the port, batched
planning is bitwise single planning, and padding to a larger bucket changes
nothing.
"""
import collections
import contextlib
import types

import jax
import jax.experimental

# The JAX package imports `jax.experimental.enable_x64`, which jax 0.9
# no longer has; alias it before anything imports `repro`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs.base import GenFVConfig as JConfig  # noqa: E402
from repro.core import mobility as j_mob  # noqa: E402
from repro.core.planner import plan_selected_jax  # noqa: E402
from repro.core.two_scale import plan_round as j_plan_round  # noqa: E402
from repro.sim import SCENARIOS as J_SCENARIOS  # noqa: E402
from repro.sim import VehicularWorld as JWorld  # noqa: E402
from repro_torch.configs.base import GenFVConfig  # noqa: E402
from repro_torch.core import mobility, planner  # noqa: E402
from repro_torch.core.generation import DiffusionService  # noqa: E402
from repro_torch.core.planner import (bucket_size, plan_rounds_batched,  # noqa: E402
                                      plan_selected_torch, selected_consts)
from repro_torch.core.two_scale import plan_round  # noqa: E402
from repro_torch.sim import VehicularWorld, get_scenario  # noqa: E402

MODEL_BITS = 11.2e6 * 32
ATOL = 1e-3          # l, phi, t_mu, t_bar: == bcd_eps
SCENARIO_NAMES = sorted(J_SCENARIOS) + ["legacy"]


def _fleets(scenario, seed=7, rounds=2):
    """(jax cfg, port cfg, [(jax fleet, port fleet)]) from the same draws."""
    rng = np.random.default_rng(seed)
    hists = rng.dirichlet(np.full(10, 0.3), size=40)
    sizes = rng.integers(500, 2000, size=40)
    if scenario == "legacy":
        cfg_a, cfg_b = JConfig(), GenFVConfig()
        return cfg_a, cfg_b, [
            (j_mob.sample_fleet(np.random.default_rng(seed + r), cfg_a, hists, sizes),
             mobility.sample_fleet(np.random.default_rng(seed + r), cfg_b, hists, sizes))
            for r in range(rounds)]
    cfg_a = J_SCENARIOS[scenario].apply(JConfig())
    cfg_b = get_scenario(scenario).apply(GenFVConfig())
    wa = JWorld(cfg_a, J_SCENARIOS[scenario], 40, np.random.default_rng(seed))
    wb = VehicularWorld(cfg_b, get_scenario(scenario), 40, np.random.default_rng(seed))
    out = []
    for r in range(rounds):
        out.append((wa.fleet(hists, sizes)[0], wb.fleet(hists, sizes)[0]))
        wa.step(np.random.default_rng(seed + r), 2.0)
        wb.step(np.random.default_rng(seed + r), 2.0)
    return cfg_a, cfg_b, out


def _alpha_k(n, k, offset):
    alpha = np.zeros(n, np.int32)
    alpha[[(offset + 3 * i) % n for i in range(min(k, n))]] = 1
    return alpha


def _assert_contract(pj, pt, what):
    np.testing.assert_array_equal(pj.alpha, pt.alpha, err_msg=f"{what}: alpha bitwise")
    assert pj.selected == pt.selected, what
    if not pj.selected:
        assert pt.b_gen == 0 and pt.bcd_iters == 0 and pt.t_bar == 0.0, what
        return
    for f in ("l", "phi", "t_mu"):
        np.testing.assert_allclose(getattr(pt, f), getattr(pj, f), rtol=0, atol=ATOL,
                                   err_msg=f"{what}: {f} within atol {ATOL}")
    assert abs(pt.t_bar - pj.t_bar) <= ATOL, f"{what}: t_bar {pt.t_bar} vs {pj.t_bar} (atol {ATOL})"
    assert abs(pt.b_gen - pj.b_gen) <= 1, f"{what}: b_gen {pt.b_gen} vs {pj.b_gen} (within 1)"
    assert pt.bcd_iters == pj.bcd_iters, f"{what}: bcd_iters {pt.bcd_iters} vs {pj.bcd_iters}"
    assert pt.converged == pj.converged, what
    np.testing.assert_array_equal(pt.t_cp, pj.t_cp, err_msg=f"{what}: t_cp (host consts) bitwise")
    np.testing.assert_allclose(pt.history, pj.history, rtol=0, atol=ATOL, err_msg=what)
    assert pt.syncs >= 2 * pt.bcd_iters + 1, what


@pytest.mark.parametrize("scenario", SCENARIO_NAMES)
def test_torch_planner_matches_jax(scenario):
    """K = 0, 1, 4, 5 (the edges of buckets 4 and 8) from each scenario's
    fleets, and SUBP1's own selection, with b_prev threaded."""
    cfg_a, cfg_b, fleets = _fleets(scenario)
    b_prev = 0
    for r, (fa, fb) in enumerate(fleets):
        overrides = [None] + [_alpha_k(len(fa), k, r) for k in (0, 1, 4, 5)]
        for bits in (MODEL_BITS, MODEL_BITS / 16):
            for ov in overrides:
                what = f"{scenario} round {r} bits {bits:.3g} K {'SUBP1' if ov is None else int(ov.sum())}"
                pj = j_plan_round(cfg_a, fa, bits, 4, b_prev=b_prev, alpha_override=ov,
                                  planner="jax")
                pt = plan_round(cfg_b, fb, bits, 4, b_prev=b_prev, alpha_override=ov,
                                planner="torch", device="cpu")
                _assert_contract(pj, pt, what)
                if ov is None:
                    b_next = pj.b_gen
        b_prev = b_next


def test_batched_equals_single_bitwise():
    """plan_rounds_batched == one plan_round per fleet, bit for bit, with
    different selected-set sizes and b_prev in one batch."""
    cfg = GenFVConfig()
    fleets = []
    for s in (0, 1, 2, 3):
        rng = np.random.default_rng(200 + s)
        hists = rng.dirichlet(np.full(10, 0.4), size=12 * (s + 1))
        sizes = rng.integers(500, 2000, size=12 * (s + 1))
        fleets.append(mobility.sample_fleet(rng, cfg, hists, sizes))
    b_prevs = [0, 5, 64, 300]
    batched = plan_rounds_batched(cfg, fleets, MODEL_BITS, batches=8,
                                  b_prevs=b_prevs, device="cpu")
    assert len({len(p.selected) for p in batched}) > 1
    for fleet, b_prev, bp in zip(fleets, b_prevs, batched):
        single = plan_round(cfg, fleet, MODEL_BITS, batches=8, b_prev=b_prev,
                            planner="torch", device="cpu")
        for f in ("alpha", "l", "phi", "t_mu", "e_total"):
            np.testing.assert_array_equal(getattr(single, f), getattr(bp, f), err_msg=f)
        for f in ("selected", "t_bar", "b_gen", "t_rsu", "bcd_iters", "history"):
            assert getattr(single, f) == getattr(bp, f), f


@pytest.mark.parametrize("k", [1, 4, 5])
def test_padding_is_neutral(k):
    """The same selected set padded into a larger bucket gives the same plan."""
    cfg = get_scenario("rush_hour").apply(GenFVConfig())
    _, _, fleets = _fleets("rush_hour", seed=3, rounds=1)
    fleet = fleets[0][1]
    consts = selected_consts(cfg, fleet, list(range(k)), 4)
    svc = DiffusionService(steps=cfg.diffusion_steps)
    base = plan_selected_torch(cfg, MODEL_BITS, consts, 9, svc, cfg.bcd_eps,
                               cfg.bcd_max_iter, device="cpu")
    for bucket in (2 * bucket_size(k), 8 * bucket_size(k)):
        big = plan_selected_torch(cfg, MODEL_BITS, consts, 9, svc, cfg.bcd_eps,
                                  cfg.bcd_max_iter, bucket=bucket, device="cpu")
        for f in ("l", "phi", "t_mu", "e_mu"):
            np.testing.assert_array_equal(big[f], base[f], err_msg=f)
        for f in ("t_bar", "b_gen", "t_rsu", "bcd_iters", "history"):
            assert big[f] == base[f], f
    with pytest.raises(ValueError, match="power of two"):
        plan_selected_torch(cfg, MODEL_BITS, consts, 0, svc, cfg.bcd_eps,
                            cfg.bcd_max_iter, bucket=6, device="cpu")


def test_projection_redo_is_exact(monkeypatch):
    """A budget projection that needs more than one water-filling step makes
    the chunk step again from its start. The plan equals a run with every
    projection given all Kp steps, and the JAX planner's plan to the
    contract. A tight budget (M = 2 subcarriers over 8 vehicles, floor
    0.15) makes the floor bind for one vehicle."""
    cfg = GenFVConfig(num_subcarriers=2, bw_l_min=0.15)
    fleet = _fleets("legacy", seed=5, rounds=1)[2][0][1]
    consts = selected_consts(cfg, fleet, list(range(8)), 4)
    svc = DiffusionService(steps=cfg.diffusion_steps)
    args = (cfg, MODEL_BITS, consts, 0, svc, cfg.bcd_eps, cfg.bcd_max_iter)
    got = plan_selected_torch(*args, device="cpu")
    assert np.sum(got["l"] == cfg.bw_l_min) == 1, got["l"]
    ref = plan_selected_jax(*args)
    for f in ("l", "phi", "t_mu"):
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=ATOL,
                                   err_msg=f"{f} within atol {ATOL}")
    assert abs(got["b_gen"] - ref["b_gen"]) <= 1
    assert got["bcd_iters"] == ref["bcd_iters"]
    calls = []
    step = planner._bandwidth_step

    def full_projection(c, st, B, D, t_cp, e_cp, valid, n_val, proj_steps):
        calls.append(proj_steps)
        return step(c, st, B, D, t_cp, e_cp, valid, n_val, valid.shape[-1])

    monkeypatch.setattr(planner, "_bandwidth_step", full_projection)
    want = plan_selected_torch(*args, device="cpu")
    assert 1 in calls
    for f in ("l", "phi", "t_mu", "e_mu"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("t_bar", "b_gen", "bcd_iters", "history"):
        assert got[f] == want[f], f
    assert got["syncs"] > want["syncs"], "the redo costs extra reads"


def test_planner_defaults_to_cuda():
    cfg = GenFVConfig()
    fleet = _fleets("legacy", rounds=1)[2][0][1]
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            plan_round(cfg, fleet, MODEL_BITS, 4, alpha_override=_alpha_k(len(fleet), 3, 0))
    with pytest.raises(ValueError, match="unknown planner"):
        plan_round(cfg, fleet, MODEL_BITS, 4, planner="jax")


# ---------------------------------------------------------------------------
# The planner's spans and step counts (`RoundPlan.steps`)
# ---------------------------------------------------------------------------
#: host reads of the SUBP1 plans of `_fleets(scenario)`: rounds 0 and 1, each
#: at MODEL_BITS and MODEL_BITS / 16, b_prev threaded; read before the
#: planner counted its steps or opened spans, and unchanged by them
SYNCS = {"highway_free_flow": [53, 111, 47, 107], "platoon": [61, 131, 65, 131],
         "rush_hour": [57, 103, 73, 93], "sparse_rural": [7, 7, 7, 4],
         "urban_stop_go": [51, 131, 45, 131], "legacy": [53, 107, 47, 125]}
#: ATen ops of one loop body at Kp 8 and 16: a bandwidth step with its
#: one-step projection, a step of the redo (all Kp projection steps), an
#: SCA power step
STEP_OPS = {8: {"bandwidth": 132, "bandwidth_redo": 496, "power": 37},
            16: {"bandwidth": 144, "bandwidth_redo": 1014, "power": 37}}


def _subp1_plans(scenario, **kw):
    cfg = get_scenario(scenario).apply(GenFVConfig()) if scenario != "legacy" \
        else GenFVConfig()
    plans, b_prev = [], 0
    for _, fleet in _fleets(scenario)[2]:
        for bits in (MODEL_BITS, MODEL_BITS / 16):
            plans.append(plan_round(cfg, fleet, bits, 4, b_prev=b_prev, planner="torch",
                                    device="cpu", **kw))
        b_prev = plans[-1].b_gen
    return plans


@pytest.mark.parametrize("scenario", sorted(SYNCS))
def test_steps_and_syncs(scenario):
    """`syncs` keeps its count; `steps` counts whole chunks of SYNC_EVERY
    bodies, one read each, beside a read a BCD iteration and the ledger's;
    no projection needs a redo on these fleets."""
    plans = _subp1_plans(scenario)
    assert [p.syncs for p in plans] == SYNCS[scenario]
    for p in plans:
        s = p.steps
        assert set(s) == {"bandwidth", "bandwidth_redo", "power"}
        assert all(n % planner.SYNC_EVERY == 0 for n in s.values()), s
        assert s["bandwidth_redo"] == 0 and s["bandwidth"] >= planner.SYNC_EVERY * p.bcd_iters
        assert p.syncs == sum(s.values()) // planner.SYNC_EVERY + p.bcd_iters + 1


def test_numpy_and_empty_plans_count_no_steps():
    cfg = GenFVConfig()
    fleet = _fleets("legacy", rounds=1)[2][0][1]
    assert plan_round(cfg, fleet, MODEL_BITS, 4, planner="numpy").steps == {}
    assert plan_round(cfg, fleet, MODEL_BITS, 4, alpha_override=np.zeros(len(fleet)),
                      device="cpu").steps == {}


def _redo_args():
    """The forced-redo fleet of test_projection_redo_is_exact."""
    cfg = GenFVConfig(num_subcarriers=2, bw_l_min=0.15)
    fleet = _fleets("legacy", seed=5, rounds=1)[2][0][1]
    consts = selected_consts(cfg, fleet, list(range(8)), 4)
    return (cfg, MODEL_BITS, consts, 0, DiffusionService(steps=cfg.diffusion_steps),
            cfg.bcd_eps, cfg.bcd_max_iter)


def test_redo_steps_only_where_a_redo_is_forced():
    got = plan_selected_torch(*_redo_args(), device="cpu")
    s = got["steps"]
    assert s["bandwidth_redo"] > 0 and s["bandwidth_redo"] % planner.SYNC_EVERY == 0
    # each redo reads once more
    assert got["syncs"] == sum(s.values()) // planner.SYNC_EVERY + got["bcd_iters"] + 1


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("bucket", sorted(STEP_OPS))
def test_ops_per_step_pinned(monkeypatch, bucket):
    """Every loop body of one part dispatches the same ATen ops, so the
    planner's ops a round are `steps` x these counts."""
    seen = {"bandwidth": set(), "bandwidth_redo": set(), "power": set()}
    bw, pw = planner._bandwidth_step, planner._power_step

    def counted(part, fn):
        def wrapped(*a):
            with _OpCount() as m:
                out = fn(*a)
            seen[part(a)].add(m.n)
            return out
        return wrapped

    monkeypatch.setattr(planner, "_bandwidth_step", counted(
        lambda a: "bandwidth" if a[-1] == 1 else "bandwidth_redo", bw))
    monkeypatch.setattr(planner, "_power_step", counted(lambda a: "power", pw))
    plan_selected_torch(*_redo_args(), bucket=bucket, device="cpu")
    assert seen == {k: {v} for k, v in STEP_OPS[bucket].items()}


class _Recorder:
    """Opens spans as the benchmark's recorder does (port_bench/recorder.py):
    not enabled, a name -> summed time map, `sync` read at exit."""
    enabled = False

    def __init__(self):
        self.opened = collections.Counter()

    def span(self, name, key=None, **tags):
        assert not tags, "tags are built only for an enabled tracer"
        self.opened[name] += 1
        return contextlib.nullcontext(types.SimpleNamespace(sync=None))


@pytest.mark.parametrize("tracer", ["obs", "recorder"])
@pytest.mark.parametrize("scenario", ["highway_free_flow", "rush_hour"])
def test_tracers_leave_plans_bitwise(tracer, scenario):
    """Plans with a tracer equal the untraced plans bit for bit; the BCD
    opens its three subproblem spans once an iteration and the ledger's
    once a plan."""
    from repro_torch.obs import Obs
    plain = _subp1_plans(scenario)
    t = Obs() if tracer == "obs" else _Recorder()
    traced = _subp1_plans(scenario, obs=t)
    for a, b in zip(plain, traced):
        for f in ("l", "phi", "t_mu"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        for f in ("t_bar", "b_gen", "bcd_iters", "history", "syncs", "steps"):
            assert getattr(a, f) == getattr(b, f), f
    iters = sum(p.bcd_iters for p in plain)
    want = {"round/plan/bandwidth": iters, "round/plan/power": iters,
            "round/plan/generation": iters, "round/plan/ledger": len(plain)}
    if tracer == "obs":
        assert t.open_spans == 0
        names = [e["name"] for e in t.events if e["ph"] == "X"]
        assert collections.Counter(names) == want
        tags = [e["tags"] for e in t.events if e["name"] == "round/plan/power"]
        assert tags == [{"bcd_iter": i} for p in plain for i in range(p.bcd_iters)]
    else:
        assert t.opened == want


def test_batched_plans_share_the_batch_counts():
    """In one batch every plan carries the batch's reads and steps (its own
    copy), and the BCD's spans open once an iteration of the longest row."""
    from repro_torch.obs import Obs
    cfg = get_scenario("rush_hour").apply(GenFVConfig())
    fleets = [f for _, f in _fleets("rush_hour")[2]]
    obs = Obs()
    plans = plan_rounds_batched(cfg, fleets, MODEL_BITS, batches=4, b_prevs=[0, 30],
                                device="cpu", obs=obs)
    a, b = plans
    assert a.steps == b.steps and a.steps is not b.steps and a.syncs == b.syncs
    iters = max(p.bcd_iters for p in plans)
    assert a.syncs == sum(a.steps.values()) // planner.SYNC_EVERY + iters + 1
    names = collections.Counter(e["name"] for e in obs.events if e["ph"] == "X")
    assert names == {"round/plan/bandwidth": iters, "round/plan/power": iters,
                     "round/plan/generation": iters, "round/plan/ledger": 1}
