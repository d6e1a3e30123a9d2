"""The port's GenFV round loop under the five registered fault schedules
against the JAX package's, on the vectorized and the sequential path
(`genfv_rounds_harness.run_faulted`: the reference plans, both runners
execute, each port round from the reference's round-start parameters).
The integer ledger and t_round are equal; loss and parameters are held to
the harness's float32 tolerances. A fault-free run whose vehicles diverge
on their own keeps the divergence on every path of both packages."""
import genfv_rounds_harness as harness
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

SCHEDULES = ("compute_stragglers", "mixed_stress", "platoon_mass_dropout",
             "poison_minority", "rush_hour_deep_fade")
CASES = [(name, vec) for name in SCHEDULES for vec in (True, False)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The test runner spreads files over worker processes on the same
    cores; torch's intra-op pool would take every core in each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=CASES, ids=[f"{n}-{'vec' if v else 'seq'}" for n, v in CASES])
def runs(request):
    return harness.run_faulted(*request.param)


def test_execution_half_ledger_equal(runs):
    harness.check_execution_half_ledger_equal(runs)


def test_execution_half_loss_and_params(runs):
    harness.check_execution_half_loss_and_params(runs)


@pytest.mark.parametrize("vectorized", [True, False])
def test_schedules_exercise_every_recovery_branch(vectorized):
    """The runs above do reach rejection, late buffering, stale merges and
    forced departures (the ledgers are equal, so the port's counts are the
    reference's)."""
    totals = dict.fromkeys(("rejected", "late", "stale_merged", "dropped"), 0)
    for name in SCHEDULES:
        for _, lt, _, _ in harness.run_faulted(name, vectorized)[1]:
            for key in totals:
                totals[key] += getattr(lt, key)
    assert all(v > 0 for v in totals.values()), totals


@pytest.mark.parametrize("lr", [1e12, 1e30])
def test_fault_free_divergence_is_not_rejected(monkeypatch, lr):
    """A vehicle that diverges on its own in a fault-free round (CLIENT_LR
    blown up in both packages) is not rejected: eq. 4 runs unguarded unless
    injected poison is in the step, so the divergence reaches the global on
    both paths of both packages. The integer ledger (rejected 0) and the
    non-finite global are the same in all four runs, and each package's two
    paths agree on whether the loss is NaN. Across packages the loss of a
    diverged network differs in how float32 overflow resolves: at lr 1e12
    the reference's loss stays finite (about 3.7e23) where the port's is
    NaN on the CPU. The first op that differs is a GroupNorm whose input
    passes sqrt(float32 max), pinned by
    `test_divergence_first_differs_at_group_norm`; both are diverged,
    which is what is held."""
    import repro.fl.rounds as j_rounds
    import repro_torch.fl.rounds as t_rounds
    monkeypatch.setattr(j_rounds, "CLIENT_LR", lr)
    monkeypatch.setattr(t_rounds, "CLIENT_LR", lr)
    kw = dict(rounds=1, train_size=400, test_size=64, strategy="fl_only", planner="numpy")
    outs = {}
    for vec in (True, False):
        ref = harness.JRunner(harness.JRunConfig(vectorized=vec, **kw),
                              fl_cfg=harness.JGenFVConfig(**harness.FAULT_CFG))
        port = harness.GenFVRunner(harness.RunConfig(vectorized=vec, **kw),
                                   fl_cfg=harness.GenFVConfig(**harness.FAULT_CFG), device="cpu")
        for name, r, flat in (("jax", ref, harness._flat_jax),
                              ("port", port, lambda p: harness.FlatSpec(p).flatten(p).numpy())):
            (log,) = r.train().logs
            outs[name, vec] = (tuple(getattr(log, f) for f in harness.INT_FIELDS),
                               bool(np.isfinite(flat(r.server.params)).all()), log.loss)
    ledger = outs["jax", True][0]
    assert all(o[0] == ledger for o in outs.values()), outs
    ints = dict(zip(harness.INT_FIELDS, ledger))
    assert ints["rejected"] == 0 and ints["selected"] > 0, ints
    assert not any(o[1] for o in outs.values()), "a global stayed finite"
    for name in ("jax", "port"):
        assert np.isnan(outs[name, True][2]) == np.isnan(outs[name, False][2]), outs
    assert np.isnan(outs["port", True][2]), outs
    assert all(np.isnan(o[2]) or abs(o[2]) > 1e20 for o in outs.values()), outs


def test_divergence_first_differs_at_group_norm():
    """Where the two packages' diverged losses part at lr 1e12: one SGD step
    of the reference from its own initial weights, those weights carried
    into the port, and the same forward op by op. The stem and the first
    block's first convolution agree and are finite, with activations past
    sqrt(float32 max) (1.8e19). The next GroupNorm is the first op that
    differs in NaN-ness: the reference's two-pass variance (mean of
    (x - mu)^2) stays finite, and so does that formula in torch, while
    F.group_norm on the CPU turns the groups NaN (its variance overflows
    float32)."""
    from repro.configs.genfv_cifar import cnn_config as j_cnn_config
    from repro.data.synthetic import make_image_dataset
    from repro.fl.client import local_sgd_steps as j_local_sgd_steps
    from repro.models import cnn as jcnn
    from repro_torch.configs.genfv_cifar import cnn_config
    from repro_torch.fl.client import images_to_device
    from repro_torch.models import cnn

    cj = j_cnn_config("cifar10", 0.25)
    x, y = make_image_dataset("cifar10", 16, seed=3)
    p1, _ = j_local_sgd_steps(jcnn.init_cnn(jax.random.PRNGKey(0), cj), cj,
                              jnp.asarray(x[None, :8]), jnp.asarray(y[None, :8]), 1, 1e12)
    pt = harness._port_params(p1)
    xj, xt = jnp.asarray(x[8:]), images_to_device(x[8:], torch.device("cpu"))

    def nchw(a):
        return np.asarray(a).transpose(0, 3, 1, 2)

    hj = jax.nn.relu(jcnn.groupnorm(p1["gn_stem"], jcnn.conv2d(p1["stem"], xj)))
    ht = torch.relu(cnn.groupnorm(pt["gn_stem"], cnn.conv2d(pt["stem"], xt)))
    np.testing.assert_allclose(ht.numpy(), nchw(hj), rtol=1e-4, atol=1e-4 * float(ht.abs().max()))
    bj, bt = p1["stages"][0][0], pt["stages"][0][0]
    cj1, ct1 = jcnn.conv2d(bj["conv1"], hj), cnn.conv2d(bt["conv1"], ht)
    assert torch.isfinite(ct1).all() and np.isfinite(np.asarray(cj1)).all()
    assert float(ct1.abs().max()) > 1.8e19
    np.testing.assert_allclose(ct1.numpy(), nchw(cj1), rtol=1e-3, atol=1e-4 * float(ct1.abs().max()))
    assert np.isfinite(np.asarray(jcnn.groupnorm(bj["gn1"], cj1))).all()
    g = cnn.num_groups(ct1.shape[1])
    xg = ct1.reshape(ct1.shape[0], g, -1)
    mu = xg.mean(-1, keepdim=True)
    two_pass = (xg - mu) * torch.rsqrt(((xg - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
    assert torch.isfinite(two_pass).all()
    assert torch.isnan(cnn.groupnorm(bt["gn1"], ct1)).any()
