"""The port's fault layer against the JAX package, bit for bit on the CPU:
the host half (`fl/faults.py`: spec validation and payload, the registry,
round-keyed draws, realized times and arrivals, the stale buffer) and the
device half of eq. 4 under faults (`aggregate_stacked_guarded`,
`add_weighted`, the server's `absorb` and the sequential `aggregate`), on
the same numpy inputs."""
import dataclasses

import jax
import jax.experimental

# The JAX package imports `jax.experimental.enable_x64`, which jax 0.9
# no longer has; alias it before anything imports `repro`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import GenFVConfig as JGenFVConfig  # noqa: E402
from repro.core import emd as j_emd  # noqa: E402
from repro.core.two_scale import plan_round as j_plan_round  # noqa: E402
from repro.fl import faults as jf  # noqa: E402
from repro.fl.generator import OracleGenerator as JOracle  # noqa: E402
from repro.fl.server import GenFVServer as JServer  # noqa: E402
from repro.sim import VehicularWorld as JWorld  # noqa: E402
from repro.sim import get_scenario as j_get_scenario  # noqa: E402
from repro_torch.core import emd as t_emd  # noqa: E402
from repro_torch.fl import faults as tf  # noqa: E402
from repro_torch.fl.generator import OracleGenerator  # noqa: E402
from repro_torch.fl.rounds import RunConfig  # noqa: E402
from repro_torch.fl.server import GenFVServer  # noqa: E402

SCHEDULES = ("compute_stragglers", "mixed_stress", "platoon_mass_dropout",
             "poison_minority", "rush_hour_deep_fade")
MODEL_BITS = 11.2e6 * 32


def _same_faults(a, b):
    for f in ("slowdown", "outage", "departed", "poisoned"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.any == b.any


# ---------------------------------------------------------------------------
# Host half
# ---------------------------------------------------------------------------
def test_registry_equals_the_reference():
    assert tf.fault_names() == jf.fault_names() == SCHEDULES
    for name in SCHEDULES:
        assert tf.get_fault(name).to_payload() == jf.get_fault(name).to_payload()
    with pytest.raises(KeyError, match="unknown fault schedule"):
        tf.get_fault("solar_flare")
    with pytest.raises(ValueError, match="already registered"):
        tf.register_fault("mixed_stress", tf.FaultSpec())
    with pytest.raises(ValueError, match="unknown fault schedule"):
        RunConfig(faults="solar_flare")
    assert RunConfig(faults="mixed_stress").faults == "mixed_stress"


@pytest.mark.parametrize("kw,fragment", [
    (dict(straggler_prob=1.5), "outside"),
    (dict(outage_prob=-0.1), "outside"),
    (dict(departure_prob=2.0), "outside"),
    (dict(poison_prob=-1.0), "outside"),
    (dict(straggler_slowdown=0.5), "slowdown"),
    (dict(deadline_slack=-1.0), "deadline_slack"),
    (dict(staleness_discount=0.0), "staleness_discount"),
    (dict(staleness_discount=1.5), "staleness_discount"),
    (dict(max_staleness=-1), "max_staleness"),
])
def test_spec_validation(kw, fragment):
    for mod in (tf, jf):
        with pytest.raises(ValueError, match=fragment):
            mod.FaultSpec(**kw)


def test_spec_active_window_and_payload():
    spec = tf.FaultSpec(seed=9, start_round=2, end_round=5, outage_prob=0.3)
    ref = jf.FaultSpec.from_payload(spec.to_payload())
    assert [spec.active(t) for t in range(7)] == [ref.active(t) for t in range(7)] \
        == [False, False, True, True, True, False, False]
    assert tf.FaultSpec.from_payload(spec.to_payload()) == spec
    assert tf.FaultSpec.from_payload(ref.to_payload()) == spec


def _specs():
    yield from ((n, tf.get_fault(n), jf.get_fault(n)) for n in SCHEDULES)
    kw = dict(seed=7, straggler_prob=0.5, outage_prob=0.5, departure_prob=0.5,
              poison_prob=0.5, start_round=1, end_round=6)
    yield "half", tf.FaultSpec(**kw), jf.FaultSpec(**kw)


@pytest.mark.parametrize("seed_shift", [0, 1, 13])
def test_draws_equal(seed_shift):
    for _, ts, js in _specs():
        ts = dataclasses.replace(ts, seed=ts.seed + seed_shift)
        js = dataclasses.replace(js, seed=js.seed + seed_shift)
        ti, ji = tf.FaultInjector(ts), jf.FaultInjector(js)
        for t in (0, 1, 2, 3, 7, 40):
            for k in (0, 1, 3, 8, 17):
                _same_faults(ti.draw(t, k), ji.draw(t, k))
                assert ti.draw(t, k).slowdown.shape == (k,)
        a = ti.draw(3, 8)
        assert not (a.departed & a.poisoned).any()


def _round_plan(seed):
    """A planned round of the reference on a scenario fleet: fleet + plan
    (host numpy planner)."""
    cfg = j_get_scenario("rush_hour").apply(JGenFVConfig())
    rng = np.random.default_rng(seed)
    world = JWorld(cfg, j_get_scenario("rush_hour"), n_partitions=40, rng=rng)
    hists = rng.dirichlet(np.full(10, 0.3), size=40)
    sizes = rng.integers(500, 2000, size=40)
    fleet, _ = world.fleet(hists, sizes)
    plan = j_plan_round(cfg, fleet, MODEL_BITS, cfg.local_steps, planner="numpy")
    return cfg, fleet, plan


@pytest.mark.parametrize("seed", [0, 3])
def test_realized_times_and_arrivals_equal(seed):
    cfg, fleet, plan = _round_plan(seed)
    k = len(plan.selected)
    assert k >= 2
    for _, ts, js in _specs():
        for t in (1, 2, 5):
            rt, rj = tf.FaultInjector(ts).draw(t, k), jf.FaultInjector(js).draw(t, k)
            a = tf.realized_times(cfg, fleet, plan, MODEL_BITS, rt, ts.outage_fade_db)
            b = jf.realized_times(cfg, fleet, plan, MODEL_BITS, rj, js.outage_fade_db)
            assert a.dtype == b.dtype and np.array_equal(a, b)
            for budget, backoff, cap in ((0, 0.1, 1.0), (3, 0.05, 0.2), (5, 0.5, 4.0)):
                kw = dict(retry_budget=budget, backoff_s=backoff, backoff_cap_s=cap)
                got = tf.realized_arrivals(cfg, fleet, plan, MODEL_BITS, rt, ts, t, **kw)
                want = jf.realized_arrivals(cfg, fleet, plan, MODEL_BITS, rj, js, t, **kw)
                for x, y in zip(got, want):
                    assert x.dtype == y.dtype and np.array_equal(x, y)
    # every position in outage, certain and impossible recovery
    for p in (0.0, 1.0):
        rt = tf.RoundFaults(np.ones(k), np.ones(k, bool), np.eye(1, k, 0, dtype=bool)[0],
                            np.zeros(k, bool))
        rj = jf.RoundFaults(rt.slowdown, rt.outage, rt.departed, rt.poisoned)
        kw = dict(retry_budget=3, backoff_s=0.1, backoff_cap_s=0.5)
        got = tf.realized_arrivals(cfg, fleet, plan, MODEL_BITS, rt, tf.FaultSpec(outage_prob=p), 4, **kw)
        want = jf.realized_arrivals(cfg, fleet, plan, MODEL_BITS, rj, jf.FaultSpec(outage_prob=p), 4, **kw)
        for x, y in zip(got, want):
            assert np.array_equal(x, y)
        assert np.isinf(got[0][0]) and got[1][0] == 0 and not got[2][0]


def _drain(buf_mod, pushes, pops):
    buf = buf_mod.StaleBuffer()
    out = []
    for (t, max_s), batch in zip(pops, pushes):
        for tr, vid in batch:
            buf.push(buf_mod.StaleEntry(params=None, size=10 + vid, emd=0.1 * vid,
                                        trained_round=tr, vid=vid))
        merge, ages, dropped = buf.pop_mergeable(t, max_s)
        out.append(([(e.vid, e.trained_round, e.size, e.emd) for e in merge], ages,
                    dropped, len(buf)))
    return out


def test_stale_buffer_equals_the_reference():
    pushes = [[(0, 0), (0, 1)], [(1, 2)], [(0, 3), (2, 4), (3, 5)], [], [(1, 6), (4, 7)]]
    pops = [(1, 2), (2, 0), (3, 2), (4, 1), (4, 3)]
    got, want = _drain(tf, pushes, pops), _drain(jf, pushes, pops)
    assert got == want
    # the boundary: age == max_staleness merges, one past it drops
    assert got[2] == ([(4, 2, 14, 0.4), (5, 3, 15, 0.5)], [1, 0], 1, 0)
    buf = tf.StaleBuffer()
    buf.push(tf.StaleEntry(None, 10, 0.5, trained_round=0, vid=0))
    assert buf.pop_mergeable(2, max_staleness=2)[1:] == ([2], 0)
    buf.push(tf.StaleEntry(None, 10, 0.5, trained_round=0, vid=1))
    assert buf.pop_mergeable(3, max_staleness=2) == ([], [], 1)


# ---------------------------------------------------------------------------
# Device half of eq. 4 under faults
# ---------------------------------------------------------------------------
SHAPES = {"a": (3, 4), "b": (5,)}       # sorted keys: the flat order


def _stacked(rng, k):
    return {n: rng.normal(size=(k,) + s).astype(np.float32) for n, s in SHAPES.items()}


def _flat(tree, lead=()):
    return np.concatenate([np.asarray(tree[n]).reshape(lead + (-1,)) for n in sorted(SHAPES)],
                          axis=-1)


def _guarded_both(stacked, weights, aug, aug_w, fb):
    j_out, j_fin = j_emd.aggregate_stacked_guarded(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(weights),
        jax.tree.map(jnp.asarray, aug), jnp.float32(aug_w), jax.tree.map(jnp.asarray, fb))
    k = len(weights)
    t_out, t_fin = t_emd.aggregate_stacked_guarded(
        torch.from_numpy(_flat(stacked, (k,))), weights,
        torch.from_numpy(_flat(aug)), aug_w, torch.from_numpy(_flat(fb)), guard=True)
    return (_flat(jax.tree.map(np.asarray, j_out)), np.asarray(j_fin),
            t_out.numpy(), t_fin.numpy())


def _weights(rng, k, pad):
    w = np.zeros(k + pad, np.float32)
    w[:k] = 0.7 * rng.dirichlet(np.ones(k))
    return w


@pytest.mark.parametrize("k,pad", [(3, 1), (5, 3), (6, 10)])
def test_guarded_neutral_on_finite_rows(k, pad):
    rng = np.random.default_rng(k)
    stacked, aug, fb = _stacked(rng, k + pad), _stacked(rng, 1), _stacked(rng, 1)
    aug, fb = ({n: v[0] for n, v in t.items()} for t in (aug, fb))
    w = _weights(rng, k, pad)
    j_out, j_fin, t_out, t_fin = _guarded_both(stacked, w, aug, 0.3, fb)
    assert j_fin.all() and t_fin.all()
    assert np.array_equal(t_out, j_out)
    plain = j_emd.aggregate_stacked(jax.tree.map(jnp.asarray, stacked), jnp.asarray(w),
                                    jax.tree.map(jnp.asarray, aug), jnp.float32(0.3))
    assert np.array_equal(t_out, _flat(jax.tree.map(np.asarray, plain)))


@pytest.mark.parametrize("bad_rows,value", [((1,), np.nan), ((0, 4), np.inf),
                                            ((2, 7), -np.inf), ((5,), np.nan)])
def test_guarded_rejects_and_renormalizes(bad_rows, value):
    """Rows with a NaN or Inf somewhere, a padded slot among them (row 7 at
    k=6, pad 2; row 5 alone is a real vehicle)."""
    rng = np.random.default_rng(11)
    k, pad = 6, 2
    stacked = _stacked(rng, k + pad)
    for r in bad_rows:
        stacked["b" if r % 2 else "a"][r].flat[r % 3] = value
    aug = {n: v[0] for n, v in _stacked(rng, 1).items()}
    fb = {n: v[0] for n, v in _stacked(rng, 1).items()}
    w = _weights(rng, k, pad)
    j_out, j_fin, t_out, t_fin = _guarded_both(stacked, w, aug, 0.25, fb)
    want = np.ones(k + pad, bool)
    want[list(bad_rows)] = False
    assert np.array_equal(t_fin, want) and np.array_equal(j_fin, want)
    assert np.isfinite(t_out).all()
    assert np.array_equal(t_out, j_out)


@pytest.mark.parametrize("bad_rows,value", [((1,), np.nan), ((0, 4), np.inf),
                                            ((2, 7), -np.inf)])
def test_unguarded_propagates_like_the_reference(bad_rows, value):
    """`guard=False` (a step without injected poison): the mask is all true
    and a non-finite row reaches the aggregate as in the JAX package's
    unguarded `aggregate_stacked`."""
    rng = np.random.default_rng(12)
    k, pad = 6, 2
    stacked = _stacked(rng, k + pad)
    for r in bad_rows:
        stacked["b" if r % 2 else "a"][r].flat[r % 3] = value
    aug = {n: v[0] for n, v in _stacked(rng, 1).items()}
    fb = {n: v[0] for n, v in _stacked(rng, 1).items()}
    w = _weights(rng, k, pad)
    want = j_emd.aggregate_stacked(jax.tree.map(jnp.asarray, stacked), jnp.asarray(w),
                                   jax.tree.map(jnp.asarray, aug), jnp.float32(0.25))
    got, fin = t_emd.aggregate_stacked_guarded(
        torch.from_numpy(_flat(stacked, (k + pad,))), w, torch.from_numpy(_flat(aug)), 0.25,
        torch.from_numpy(_flat(fb)), guard=False)
    want = _flat(jax.tree.map(np.asarray, want))
    assert fin.all() and not np.isfinite(want).all()
    assert np.array_equal(got.numpy(), want, equal_nan=True)


def test_guarded_all_rows_poisoned_falls_back():
    rng = np.random.default_rng(5)
    k = 4
    stacked = {n: np.full((k,) + s, np.nan, np.float32) for n, s in SHAPES.items()}
    aug = {n: v[0] for n, v in _stacked(rng, 1).items()}
    fb = {n: v[0] for n, v in _stacked(rng, 1).items()}
    w = _weights(rng, k, 0)
    j_out, j_fin, t_out, t_fin = _guarded_both(stacked, w, aug, 0.2, fb)
    assert not t_fin.any() and not j_fin.any()
    assert np.array_equal(t_out, j_out)
    s_all = np.float32(0)
    for x in w:
        s_all = np.float32(s_all + x)
    np.testing.assert_array_equal(
        t_out, s_all * _flat(fb) + np.float32(0.2) * _flat(aug))


def _trees(rng, n):
    return [{name: rng.normal(size=s).astype(np.float32) for name, s in SHAPES.items()}
            for _ in range(n)]


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _same_tree(port, ref):
    for k in SHAPES:
        assert np.array_equal(port[k].numpy(), np.asarray(ref[k])), k


@pytest.mark.parametrize("n", [0, 1, 4])
def test_add_weighted_equals_the_reference(n):
    rng = np.random.default_rng(n)
    p, models = _trees(rng, 1)[0], _trees(rng, n)
    ws = list(rng.random(n) * 0.3)
    ref = j_emd.add_weighted(jax.tree.map(jnp.asarray, p),
                             [jax.tree.map(jnp.asarray, m) for m in models], ws)
    got = t_emd.add_weighted(_t(p), [_t(m) for m in models], ws)
    _same_tree(got, ref)


@pytest.mark.parametrize("weight", [0.0, 0.0625, 0.3141, 1.0])
def test_absorb_equals_the_reference(weight):
    rng = np.random.default_rng(7)
    p, m = _trees(rng, 2)
    js = JServer(None, jax.tree.map(jnp.asarray, p), JOracle("cifar10"), None)
    ts = GenFVServer(None, _t(p), OracleGenerator("cifar10"), None)
    ref = js.absorb(jax.tree.map(jnp.asarray, m), weight)
    got = ts.absorb(_t(m), weight)
    _same_tree(got, ref)
    _same_tree(ts.params, js.params)


@pytest.mark.parametrize("n,with_aug", [(1, True), (3, True), (5, False), (0, True),
                                        (0, False), (2, False), (4, True)])
def test_sequential_aggregate_equals_the_reference(n, with_aug):
    rng = np.random.default_rng(n + 10 * with_aug)
    p, aug = _trees(rng, 2)
    models = _trees(rng, n)
    sizes = list(rng.integers(10, 500, size=n))
    emds = list(rng.random(n) * 1.8)
    js = JServer(None, jax.tree.map(jnp.asarray, p), JOracle("cifar10"), None)
    ts = GenFVServer(None, _t(p), OracleGenerator("cifar10"), None)
    ref, rk = js.aggregate([jax.tree.map(jnp.asarray, m) for m in models], sizes, emds,
                           jax.tree.map(jnp.asarray, aug) if with_aug else None)
    got, tk = ts.aggregate([_t(m) for m in models], sizes, emds,
                           _t(aug) if with_aug else None)
    assert tk == rk
    _same_tree(got, ref)


def test_tree_finite():
    rng = np.random.default_rng(1)
    tree = _t(_trees(rng, 1)[0])
    assert t_emd.tree_finite(tree) and j_emd.tree_finite(jax.tree.map(np.asarray, tree))
    tree["b"][2] = float("inf")
    assert not t_emd.tree_finite(tree)
    assert not j_emd.tree_finite({k: v.numpy() for k, v in tree.items()})
