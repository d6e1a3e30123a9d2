"""The port's GenFV device layer against the JAX package on the CPU: the
GroupNorm ResNet-18 (`models/cnn.py`) at width 0.25, local SGD with and
without the FedProx term, eq. 4 and the vmapped fleet step, all on
parameters made by the JAX package and carried over with
`convert.from_jax_cnn_params`.

Two kinds of tolerance:
* float64 (both packages in float64; the cross-entropy stays float32 in
  both, as specified): the math is the same, up to the float32 softmax.
* float32: GroupNorm's backward after the global mean pool cancels most
  of its incoming gradient, so a float32 gradient lies far more than
  float32's unit from the float64 one, by an amount that depends on the
  convolution algorithm; two float32 implementations are held to bounds
  that cover this, stated in each assert.
"""
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
import torch.nn.functional as F  # noqa: E402

from repro.configs.genfv_cifar import cnn_config as j_cnn_config  # noqa: E402
from repro.core.emd import aggregate_stacked as j_aggregate_stacked  # noqa: E402
from repro.data.synthetic import make_image_dataset  # noqa: E402
from repro.fl.client import local_sgd as j_local_sgd  # noqa: E402
from repro.fl.fleet import FleetEngine as JFleetEngine  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.configs.genfv_cifar import cnn_config  # noqa: E402
from repro_torch.convert import from_jax_cnn_params  # noqa: E402
from repro_torch.core.emd import aggregate_stacked_guarded, kappas  # noqa: E402
from repro_torch.fl.client import (images_to_device, labels_to_device,  # noqa: E402
                                   local_sgd_steps)
from repro_torch.fl.fleet import FleetEngine  # noqa: E402
from repro_torch.fl.rounds import CLIENT_LR  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.tree import FlatSpec, tree_leaves, tree_map  # noqa: E402

CFG_J = j_cnn_config("cifar10", 0.25)
CFG = cnn_config("cifar10", 0.25)
CPU = "cpu"

LOGIT_TOL64 = 1e-12     # x max|logit|
GRAD_TOL64 = 1e-6       # x max|grad|: the cross-entropy stays float32
LOGIT_TOL32 = 1e-5      # x max(1, max|logit|)
GRAD_TOL32 = 1e-3       # relative L2 norm of the whole gradient
SGD_TOL64 = 1e-7        # params after h steps, absolute
AGG_TOL32 = 5e-4        # fleet aggregate against the JAX engine, absolute


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The test runner spreads files over worker processes on the same
    cores; torch's intra-op pool would take every core in each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _flat_jax(tree):
    """JAX tree -> flat numpy in the port's layout (convs to OIHW)."""
    return np.concatenate([
        (np.asarray(x).transpose(3, 2, 0, 1) if np.ndim(x) == 4 else np.asarray(x)).ravel()
        for x in jax.tree.leaves(tree)])


def _flat(tree):
    return FlatSpec(tree).flatten(tree).detach().cpu().numpy()


def _double(tree):
    return tree_map(lambda x: x.double(), tree)


@pytest.fixture(scope="module")
def params():
    pj = jcnn.init_cnn(jax.random.PRNGKey(0), CFG_J)
    aug = jcnn.init_cnn(jax.random.PRNGKey(1), CFG_J)
    np_tree = jax.tree.map(np.asarray, pj)
    return pj, from_jax_cnn_params(np_tree, device=CPU), aug, \
        from_jax_cnn_params(jax.tree.map(np.asarray, aug), device=CPU)


@jax.jit
def _jax_logits_loss_grad(p, x, y):
    (loss, logits), g = jax.value_and_grad(
        lambda pp: jcnn.cnn_loss(pp, CFG_J, {"images": x, "labels": y}), has_aux=True)(p)
    return logits, loss, g


def _batch(seed, n=16):
    return make_image_dataset("cifar10", n, seed=seed)


def _port_grad(pt, x, y, dtype=torch.float32):
    spec = FlatSpec(pt)
    flat = spec.flatten(pt).to(dtype)
    xs = images_to_device(x, CPU, dtype)
    ys = labels_to_device(y, CPU)
    g, loss = torch.func.grad_and_value(
        lambda w: cnn.cnn_loss(spec.unflatten(w), CFG, xs, ys)[0])(flat)
    return g.numpy(), float(loss)


def test_converted_layout(params):
    pj, pt, _, _ = params
    assert [tuple(x.shape) for x in tree_leaves(pt)] == [
        (s[3], s[2], s[0], s[1]) if len(s) == 4 else s
        for s in (np.shape(x) for x in jax.tree.leaves(pj))]
    assert FlatSpec(pt).numel == sum(np.size(x) for x in jax.tree.leaves(pj))
    init = cnn.init_cnn(torch.Generator().manual_seed(0), CFG, device=CPU)
    assert [tuple(x.shape) for x in tree_leaves(init)] == \
        [tuple(x.shape) for x in tree_leaves(pt)]
    conv = init["stages"][1][0]["conv1"]
    assert abs(float(conv.std()) - (2.0 / (9 * conv.shape[1])) ** 0.5) < 0.1 * (2.0 / (9 * conv.shape[1])) ** 0.5
    assert float(init["head"]["b"].abs().max()) == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cnn.init_cnn(torch.Generator().manual_seed(0), CFG)
        with pytest.raises(RuntimeError, match="cuda"):
            from_jax_cnn_params(jax.tree.map(np.asarray, pj))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cnn_float64_matches_jax(params, seed):
    """Logits, loss and every gradient leaf in float64."""
    pj, pt, _, _ = params
    x, y = _batch(seed)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), pj)
        want_logits, want_loss, g = _jax_logits_loss_grad(
            p64, jnp.asarray(x, jnp.float64), jnp.asarray(y))
        want_logits, want_grad = np.asarray(want_logits), _flat_jax(g)
    logits = cnn.cnn_forward(_double(pt), CFG, images_to_device(x, CPU, torch.float64))
    err = np.abs(logits.numpy() - want_logits).max()
    assert err <= LOGIT_TOL64 * np.abs(want_logits).max(), f"logits {err:.3e} (tol {LOGIT_TOL64} x max)"
    grad, loss = _port_grad(_double(pt), x, y, torch.float64)
    assert abs(loss - float(want_loss)) <= 1e-6, (loss, float(want_loss))
    err = np.abs(grad - want_grad).max()
    assert err <= GRAD_TOL64 * np.abs(want_grad).max(), f"grads {err:.3e} (tol {GRAD_TOL64} x max)"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cnn_float32_matches_jax(params, seed):
    pj, pt, _, _ = params
    x, y = _batch(seed)
    want_logits, want_loss, g = _jax_logits_loss_grad(pj, jnp.asarray(x), jnp.asarray(y))
    want_logits = np.asarray(want_logits)
    logits = cnn.cnn_forward(pt, CFG, images_to_device(x, CPU)).detach().numpy()
    err = np.abs(logits - want_logits).max()
    assert err <= LOGIT_TOL32 * max(1.0, np.abs(want_logits).max()), f"logits {err:.3e}"
    grad, loss = _port_grad(pt, x, y)
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss)), (loss, float(want_loss))
    want = _flat_jax(g)
    rel = np.linalg.norm(grad - want) / np.linalg.norm(want)
    assert rel <= GRAD_TOL32, f"gradient relative L2 error {rel:.3e} > {GRAD_TOL32}"


def test_stride2_same_padding_trap():
    """JAX "SAME" pads a stride-2 3x3 convolution by (0, 1); a symmetric
    padding=1 shifts every output pixel. 32x32 input, as the model sees."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 16)).astype(np.float32)
    w = rng.normal(size=(3, 3, 16, 32)).astype(np.float32)
    for stride, k in ((2, 3), (1, 3), (2, 1)):
        wk = w[:k, :k] if k == 3 else w[1:2, 1:2]
        want = np.asarray(jcnn.conv2d(jnp.asarray(wk), jnp.asarray(x), stride))
        wt = torch.from_numpy(np.ascontiguousarray(wk.transpose(3, 2, 0, 1)))
        got = cnn.conv2d(wt, images_to_device(x, CPU), stride).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=f"stride {stride} k {k} within 1e-4")
        if stride == 2 and k == 3:
            naive = F.conv2d(images_to_device(x, CPU), wt, stride=2, padding=1)
            assert np.abs(naive.permute(0, 2, 3, 1).numpy() - want).max() > 1.0
    assert [cnn.num_groups(c) for c in (3, 4, 8, 12, 16, 20, 64)] == [3, 4, 8, 6, 8, 5, 8]


@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
def test_local_sgd_steps_match_jax(params, prox_mu):
    """h = 2 steps at the runner's learning rate: float64 tight; float32
    losses within 1e-5 relative."""
    pj, pt, _, _ = params
    x, y = _batch(5, 32)
    bi, bl = x.reshape(2, 16, 32, 32, 3), y.reshape(2, 16)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), pj)
        pa, la = j_local_sgd(p64, CFG_J, jnp.asarray(bi, jnp.float64),
                             jnp.asarray(bl), 2, CLIENT_LR, prox_mu)
        want, want_losses = _flat_jax(pa), np.asarray(la)
    pb, lb = local_sgd_steps(_double(pt), CFG, images_to_device(bi, CPU, torch.float64),
                             labels_to_device(bl, CPU), 2, CLIENT_LR, prox_mu)
    err = np.abs(_flat(pb) - want).max()
    assert err <= SGD_TOL64, f"float64 params after 2 steps: {err:.3e} > {SGD_TOL64}"
    np.testing.assert_allclose(lb.detach().numpy(), want_losses, rtol=1e-6)
    pa32, la32 = j_local_sgd(pj, CFG_J, jnp.asarray(bi), jnp.asarray(bl), 2, CLIENT_LR,
                             prox_mu)
    pb32, lb32 = local_sgd_steps(pt, CFG, images_to_device(bi, CPU), labels_to_device(bl, CPU),
                                 2, CLIENT_LR, prox_mu)
    np.testing.assert_allclose(lb32.detach().numpy(), np.asarray(la32), rtol=1e-5)
    err = np.abs(_flat(pb32) - _flat_jax(pa32)).max()
    assert err <= AGG_TOL32, f"float32 params after 2 steps: {err:.3e} > {AGG_TOL32}"


def test_aggregate_stacked_matches_jax_bitwise():
    """Eq. 4's ordered chain, with its finiteness guard, gives the JAX
    package's unguarded float32 result bit for bit on the CPU on finite
    rows, with and without padding slots of weight 0."""
    rng = np.random.default_rng(0)
    s = rng.normal(size=(8, 3000)).astype(np.float32)
    a = rng.normal(size=3000).astype(np.float32)
    k1, k2 = kappas(1.23)
    for k in (1, 3, 5, 8):
        w = np.zeros(8, np.float32)
        w[:k] = k1 * rng.dirichlet(np.ones(k))
        want = np.asarray(j_aggregate_stacked({"x": jnp.asarray(s)}, jnp.asarray(w),
                                              {"x": jnp.asarray(a)}, jnp.float32(k2))["x"])
        got, finite = aggregate_stacked_guarded(torch.from_numpy(s), w, torch.from_numpy(a),
                                                np.float32(k2), torch.from_numpy(a),
                                                guard=True)
        assert np.array_equal(got.numpy(), want) and finite.all(), k
        short, _ = aggregate_stacked_guarded(torch.from_numpy(s[:k]), w[:k],
                                             torch.from_numpy(a), np.float32(k2),
                                             torch.from_numpy(a), guard=True)
        assert np.array_equal(short.numpy(), want), f"padding moved the aggregate at K={k}"
    with pytest.raises(ValueError):
        aggregate_stacked_guarded(torch.from_numpy(s), w[:3], torch.from_numpy(a), 0.0,
                                  torch.from_numpy(a), guard=True)


def _fleet_inputs(k, h=2, batch=8):
    rng = np.random.default_rng(k)
    eng = FleetEngine(CFG, h, batch, CLIENT_LR)
    data = [make_image_dataset("cifar10", 40, seed=10 * k + v) for v in range(k)]
    bis, bls = zip(*[eng.sample_batches(rng, d[0], d[1]) for d in data])
    rhos = rng.dirichlet(np.ones(k))
    emds = rng.uniform(0.2, 1.6, size=k)
    return eng, list(bis), list(bls), rhos, float(np.mean(emds))


@pytest.mark.parametrize("k", [3, 5])
def test_fleet_run_matches_jax(params, k):
    """The vmapped fleet step with eq. 4 against the JAX engine, float32:
    aggregate within AGG_TOL32 absolute, per-vehicle mean losses within
    1e-3 relative (the second step starts from float32 gradients that
    already differ)."""
    pj, pt, aug_j, aug_t = params
    eng, bis, bls, rhos, emd_bar = _fleet_inputs(k)
    je = JFleetEngine(CFG_J, eng.h, eng.batch_size, CLIENT_LR)
    want, want_losses = je.run(jax.tree.map(jnp.asarray, pj), bis, bls, rhos, emd_bar, aug_j)
    got, losses, finite = eng.run(pt, bis, bls, rhos, emd_bar, aug_t, guard=True)
    assert finite.all() and finite.shape == (k,)
    err = np.abs(_flat(got) - _flat_jax(want)).max()
    assert err <= AGG_TOL32, f"K={k}: aggregate {err:.3e} > {AGG_TOL32}"
    np.testing.assert_allclose(losses, np.asarray(want_losses), rtol=1e-3)
    plain, _, _ = eng.run(pt, bis, bls, rhos, guard=True)  # no omega_a: kappa2 = 0
    want_plain, _ = je.run(jax.tree.map(jnp.asarray, pj), bis, bls, rhos)
    err = np.abs(_flat(plain) - _flat_jax(want_plain)).max()
    assert err <= AGG_TOL32, f"K={k} without omega_a: {err:.3e} > {AGG_TOL32}"


def test_fleet_run_rejects_a_poisoned_vehicle(params):
    """A vehicle whose batches are NaN (a poisoned upload, fl/faults.py)
    leaves eq. 4: the finite mask marks it alone and equals the JAX
    engine's guarded step's, whose aggregate the port's is within AGG_TOL32
    of; and the aggregate is the step of the other four with their weights
    renormalised, up to the float32 rounding of the renormalisation."""
    pj, pt, aug_j, aug_t = params
    eng, bis, bls, rhos, emd_bar = _fleet_inputs(5)
    bad = 2
    poisoned = list(bis)
    poisoned[bad] = np.full_like(bis[bad], np.nan)
    got, losses, finite = eng.run(pt, poisoned, bls, rhos, emd_bar, aug_t, guard=True)
    assert finite.tolist() == [i != bad for i in range(5)]
    assert np.isfinite(_flat(got)).all()
    assert np.isnan(losses[bad]) and np.isfinite(np.delete(losses, bad)).all()
    je = JFleetEngine(CFG_J, eng.h, eng.batch_size, CLIENT_LR)
    want, _, want_finite = je.run(jax.tree.map(jnp.asarray, pj), poisoned, bls, rhos, emd_bar,
                                  aug_j, guard=True)
    assert np.array_equal(np.asarray(want_finite), finite)
    err = np.abs(_flat(got) - _flat_jax(want)).max()
    assert err <= AGG_TOL32, f"poisoned fleet step: {err:.3e} > {AGG_TOL32}"
    keep = [i for i in range(5) if i != bad]
    clean, _, _ = eng.run(pt, [bis[i] for i in keep], [bls[i] for i in keep],
                          rhos[keep] / rhos[keep].sum(), emd_bar, aug_t, bucket=8, guard=True)
    np.testing.assert_allclose(_flat(got), _flat(clean), rtol=0, atol=1e-6)


def test_fleet_run_float64_is_per_vehicle_and_bucket_free(params):
    """In float64 on the CPU the vmapped step equals K separate
    `local_sgd_steps` calls followed by eq. 4, and buckets 4
    and 8 give the same aggregate, bit for bit."""
    _, pt, _, aug_t = params
    eng, bis, bls, rhos, emd_bar = _fleet_inputs(3)
    p64, a64 = _double(pt), _double(aug_t)
    outs = {kb: eng.run(p64, bis, bls, rhos, emd_bar, a64, prox_mu=0.1, bucket=kb,
                        guard=True)
            for kb in (4, 8)}
    assert np.array_equal(_flat(outs[4][0]), _flat(outs[8][0]))
    assert np.array_equal(outs[4][1], outs[8][1])
    models, losses = [], []
    for bi, bl in zip(bis, bls):
        m, lv = local_sgd_steps(p64, CFG, images_to_device(bi, CPU, torch.float64),
                                labels_to_device(bl, CPU), eng.h, CLIENT_LR, 0.1)
        models.append(FlatSpec(m).flatten(m))
        losses.append(float(lv.mean()))
    k1, k2 = kappas(emd_bar)
    want, _ = aggregate_stacked_guarded(torch.stack(models), np.float32(k1 * rhos),
                                        FlatSpec(a64).flatten(a64), np.float32(k2),
                                        FlatSpec(p64).flatten(p64), guard=True)
    assert np.array_equal(_flat(outs[4][0]), want.numpy())
    np.testing.assert_allclose(outs[4][1], losses, rtol=1e-12)


def test_fleet_bucket_invariance_float32_cpu(params):
    """K = 3 at bucket 4 against bucket 8, float32 on the CPU: not bitwise
    (oneDNN's grouped convolution rounds differently for 4 and 8 groups, and
    the GroupNorm cancellation amplifies it), held to AGG_TOL32; larger
    buckets agree bit for bit with bucket 8."""
    _, pt, _, aug_t = params
    eng, bis, bls, rhos, emd_bar = _fleet_inputs(3)
    outs = {kb: eng.run(pt, bis, bls, rhos, emd_bar, aug_t, bucket=kb, guard=True)
            for kb in (4, 8, 16)}
    err = np.abs(_flat(outs[4][0]) - _flat(outs[8][0])).max()
    assert err <= AGG_TOL32, f"bucket 4 vs 8: {err:.3e} > {AGG_TOL32}"
    np.testing.assert_allclose(outs[4][1], outs[8][1], rtol=1e-5)
    assert np.array_equal(_flat(outs[8][0]), _flat(outs[16][0]))
    with pytest.raises(ValueError, match="smaller"):
        eng.run(pt, bis, bls, rhos, bucket=2, guard=True)
    with pytest.raises(ValueError, match="at least one"):
        eng.run(pt, [], [], [], guard=True)
