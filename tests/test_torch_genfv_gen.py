"""The port's AIGC dataplane (`repro_torch.{optim,diffusion,gen}`, the
converter `convert.from_jax_unet_params`) against the JAX package's on the
CPU, at the tiny size of the JAX package's own tests
(`DDPM(timesteps=8, num_classes=10, base_width=8)`), on the same
numpy-seeded inputs and converted parameters.

Torch cannot draw JAX's threefry streams, so where the JAX function draws
(the loss's t and eps, the sampler's noise, the pretraining's init) the test
reproduces the JAX package's draws with `jax.random` and hands them to the
port. The port's own streams are held to the reference's contracts instead:
image j of a schedule depends only on (params, round key, start + j, label),
so fused == per-label == offset shard and padding is neutral, bit for bit
on the CPU.

Tolerances, each set after measuring (the measured value in brackets).
The time embedding is float32 in both packages, also under float64 (the
JAX package's), and XLA's float32 sin, cos and exp differ from torch's by
an ulp, so float64 agrees to about 1e-8, not to float64 rounding:
* UNet forward: float64 within UNET_TOL64 x max|out| [5.8e-9]; each
  package's float32 within UNET_TOL32 x max|out| of float64 [6e-7].
* ddpm_loss: float64 within LOSS_RTOL64 relative [6.2e-11]; float32 within
  LOSS_RTOL32 [1.6e-6].
* adamw: within 1e-7 x max(1, max|param|) after 3 steps (the bias
  corrections' float32 pow may round apart by an ulp).
* pretraining, 3 steps: per-step losses within PRETRAIN_LOSS_RTOL
  [3.6e-7], parameters within PRETRAIN_PARAM_TOL [1.2e-7]; Adam's
  m/sqrt(v) turns a rounding difference in a near-zero gradient into a
  step of up to lr (2e-4), which these draws do not meet.
* sampling (images in [-1, 1]): float64 within SAMPLE_TOL64 [2.1e-9],
  float32 within SAMPLE_TOL32 [9.2e-7 strided, 5.4e-7 the full chain].
"""
import json

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

import repro.diffusion.ddpm as jddpm  # noqa: E402
import repro.gen.pretrain as jpretrain  # noqa: E402
import repro.gen.sampler as jsampler  # noqa: E402
import repro.gen.service as jservice  # noqa: E402
from repro.diffusion import unet as junet  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import constant_schedule as j_constant_schedule  # noqa: E402
import repro_torch.gen.calib as calib  # noqa: E402
from repro_torch.convert import from_jax_unet_params  # noqa: E402
from repro_torch.core.generation import label_schedule  # noqa: E402
from repro_torch.diffusion import unet  # noqa: E402
from repro_torch.diffusion.ddpm import (DDPM, ddpm_loss, ddpm_sample,  # noqa: E402
                                        make_ddpm)
from repro_torch.fl.generator import DDPMGenerator  # noqa: E402
from repro_torch.gen import (BatchedDDPMGenerator, CALIB_SCHEMA,  # noqa: E402
                             DDPM_CKPT_SCHEMA, MeasuredService,
                             calibrated_service, gen_round_key, image_noise,
                             load_calibration, load_pretrained, pretrain_ddpm,
                             sample_schedule, save_calibration,
                             strided_timesteps)
from repro_torch.gen.sampler import _sample_strided  # noqa: E402
from repro_torch.optim import adamw, constant_schedule  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TINY = DDPM(timesteps=8, num_classes=10, base_width=8)
J_TINY = jddpm.DDPM(timesteps=8, num_classes=10, base_width=8)
CPU = "cpu"
UNET_TOL64 = 1e-7     # x max|out|, float64 forward
UNET_TOL32 = 1e-5     # x max|out|, each float32 forward from float64
LOSS_RTOL64 = 1e-9
LOSS_RTOL32 = 1e-5
SAMPLE_TOL64 = 1e-7   # images in [-1, 1]
SAMPLE_TOL32 = 1e-5
PRETRAIN_LOSS_RTOL = 1e-5
PRETRAIN_PARAM_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The test runner spreads files over worker processes on the same
    cores; torch's intra-op pool would take every core in each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _random_jax_unet(seed):
    """A JAX-layout UNet tree (numpy) whose every leaf is drawn at unit
    scale per fan-in, so each branch (the residual blocks' second
    convolutions, attention's output, the output convolution, GroupNorm's
    affine) moves the output; the init's 1e-3 scales would hide them."""
    tree = jax.tree.map(np.asarray, junet.init_unet(jax.random.PRNGKey(seed), 10, base=8))
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name.endswith("['bias']"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1]))
        return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def unet_params():
    tree = _random_jax_unet(0)
    return tree, from_jax_unet_params(tree, device=CPU)


def _to64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2).to(dtype)


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def test_strided_timesteps_match_jax():
    for T, S in ((8, 1), (8, 4), (8, 8), (200, 5), (200, 50), (200, 200), (1000, 37)):
        assert np.array_equal(strided_timesteps(T, S), jsampler.strided_timesteps(T, S))
        assert strided_timesteps(T, S).dtype == np.int64
    for bad in (0, 201):
        with pytest.raises(ValueError):
            strided_timesteps(200, bad)


def _ulps(a, b):
    ints = {np.float32: np.int32, np.float64: np.int64}[a.dtype.type]
    return int(np.abs(a.view(ints).astype(np.int64) - b.view(ints).astype(np.int64)).max())


def test_alpha_bars_pinned_to_jax():
    """The JAX package computes its schedule inside jitted functions (XLA
    folds it into a constant) and eagerly in tests; the two agree on
    alpha_bars and differ by up to an ulp on betas. The port: bitwise at 8
    timesteps, in float64 at 200, and within one ulp in float32 at 200."""
    for T, x64, max_ulps in ((8, False, 0), (8, True, 0), (200, True, 0), (200, False, 1)):
        dt = np.float64 if x64 else np.float32
        with jax.enable_x64(x64):
            d = jddpm.DDPM(timesteps=T)
            folded = np.asarray(jax.jit(d.alpha_bars)())
            eager = np.asarray(d.alpha_bars())
            betas = np.asarray(jax.jit(d.betas)())
        port = DDPM(timesteps=T)
        assert folded.dtype == eager.dtype == port.alpha_bars(dt).dtype == dt
        for ref in (folded, eager):
            assert _ulps(port.alpha_bars(dt), ref) <= max_ulps, (T, x64)
        assert _ulps(port.betas(dt), betas) <= 1
        assert np.all(np.diff(port.alpha_bars(dt)) < 0)


# ---------------------------------------------------------------------------
# UNet and loss
# ---------------------------------------------------------------------------
def test_nearest_resize_matches_jax():
    """`jax.image.resize(..., "nearest")` at exactly 2x (8 -> 16 -> 32 in
    the UNet) is `F.interpolate(mode="nearest")`, bit for bit."""
    a = np.random.default_rng(0).standard_normal((2, 8, 8, 5)).astype(np.float32)
    for size in (16, 32):
        x = a if size == 16 else np.repeat(np.repeat(a, 2, 1), 2, 2)
        want = np.asarray(jax.image.resize(x, (2, size, size, 5), "nearest"))
        assert np.array_equal(_nhwc(unet._up2(_nchw(x))), want)


def _unet_inputs(B=5, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 8, B), rng.integers(0, 10, B))


def test_unet_forward_matches_jax(unet_params):
    tree, pt = unet_params
    x, t, y = _unet_inputs()
    assert [a.shape for a in tree_leaves(pt)] == [
        a.transpose(3, 2, 0, 1).shape if a.ndim == 4 else a.shape
        for a in jax.tree.leaves(tree)]
    with jax.enable_x64(True):
        want64 = np.asarray(junet.unet_apply(_to64(tree), jnp.asarray(x, jnp.float64),
                                             jnp.asarray(t), jnp.asarray(y)))
    want32 = np.asarray(junet.unet_apply(tree, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    tt, yt = torch.from_numpy(t), torch.from_numpy(y)
    got64 = _nhwc(unet.unet_apply(tree_map(lambda a: a.double(), pt),
                                  _nchw(x, torch.float64), tt, yt))
    got32 = _nhwc(unet.unet_apply(pt, _nchw(x), tt, yt))
    m = np.abs(want64).max()
    assert m > 0.5
    assert np.abs(got64 - want64).max() <= UNET_TOL64 * m
    for who, out in (("port", got32), ("JAX", want32)):
        err = np.abs(out - want64).max()
        assert err <= UNET_TOL32 * m, f"{who} float32 forward {err:.3e} from float64"


def test_ddpm_loss_matches_jax_with_injected_draws(unet_params):
    """JAX's ddpm_loss draws t and eps from its key; the port takes them:
    the same draws give the same loss."""
    tree, pt = unet_params
    x0, _, y = _unet_inputs(B=6, seed=2)
    key = jax.random.PRNGKey(11)
    kt, ke = jax.random.split(key)
    t = np.array(jax.random.randint(kt, (6,), 0, TINY.timesteps))
    eps = np.array(jax.random.normal(ke, x0.shape))
    want32 = float(jddpm.ddpm_loss(tree, J_TINY, key, jnp.asarray(x0), jnp.asarray(y)))
    with jax.enable_x64(True):           # x64 draws other bits
        kt, ke = jax.random.split(key)
        t64 = np.array(jax.random.randint(kt, (6,), 0, TINY.timesteps))
        eps64 = np.array(jax.random.normal(ke, x0.shape))
        want64 = float(jddpm.ddpm_loss(_to64(tree), J_TINY, key, jnp.asarray(x0, jnp.float64),
                                       jnp.asarray(y)))
    tt, yt = torch.from_numpy(t), torch.from_numpy(y)
    got32 = float(ddpm_loss(pt, TINY, _nchw(x0), yt, tt, _nchw(eps)))
    got64 = float(ddpm_loss(tree_map(lambda a: a.double(), pt), TINY, _nchw(x0, torch.float64),
                            yt, torch.from_numpy(t64), _nchw(eps64, torch.float64)))
    assert abs(got64 - want64) <= LOSS_RTOL64 * want64, (got64, want64)
    assert abs(got32 - want32) <= LOSS_RTOL32 * want32, (got32, want32)


# ---------------------------------------------------------------------------
# optimizer and pretraining
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adamw_matches_jax(weight_decay):
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": [rng.standard_normal(7).astype(np.float32)]}
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 10.0 ** rng.integers(-6, 2)
                                     ).astype(np.float32), params) for _ in range(3)]
    jopt = j_adamw(j_constant_schedule(2e-4), weight_decay=weight_decay)
    opt = adamw(constant_schedule(2e-4), weight_decay=weight_decay)
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = jopt.init(jp)
    tp = tree_map(torch.from_numpy, params)
    ts = opt.init(tp)
    for g in grads:
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = opt.update(tree_map(torch.from_numpy, g), ts, tp)
    assert ts["step"] == int(js["step"]) == 3
    for a, b in zip(jax.tree.leaves((jp, js["m"], js["v"])),
                    tree_leaves((tp, ts["m"], ts["v"]))):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-7 * max(1.0, np.abs(np.asarray(a)).max())


def _jax_pretrain_draws(ddpm, seed, steps, batch):
    """The JAX package's pretraining init and per-step (t, eps), drawn as
    `repro.gen.pretrain.pretrain_ddpm` draws them."""
    ss = np.random.SeedSequence(entropy=(int(seed), 0, jpretrain.PRETRAIN_KEY))
    init_key = jnp.asarray(ss.generate_state(2, np.uint32))
    draws = []
    for s in range(steps):
        kt, ke = jax.random.split(jax.random.fold_in(init_key, s + 1))
        draws.append((np.array(jax.random.randint(kt, (batch,), 0, ddpm.timesteps)),
                       np.array(jax.random.normal(ke, (batch, 32, 32, 3)))))
    return jddpm.make_ddpm(init_key, ddpm), draws


def test_pretrain_matches_jax_with_injected_init_and_draws():
    """Three steps of the reference-pool loop: the batch indices are the
    same numpy stream in both packages; the init and the loss draws are the
    JAX package's, handed to the port."""
    kw = dict(steps=3, ref_size=64, batch=8, seed=0)
    want_params, want_losses = jpretrain.pretrain_ddpm(J_TINY, **kw)
    init, draws = _jax_pretrain_draws(J_TINY, 0, 3, 8)
    got_params, got_losses = pretrain_ddpm(
        TINY, device=CPU, draws=draws,
        init_params=from_jax_unet_params(jax.tree.map(np.asarray, init), device=CPU), **kw)
    np.testing.assert_allclose(got_losses, want_losses, rtol=PRETRAIN_LOSS_RTOL)
    want = from_jax_unet_params(want_params, device=CPU)
    errs = [float((a - b).abs().max()) for a, b in zip(tree_leaves(got_params),
                                                       tree_leaves(want))]
    assert max(errs) <= PRETRAIN_PARAM_TOL, max(errs)


def test_pretrain_deterministic_and_checkpointed(tmp_path):
    ck = str(tmp_path / "ddpm")
    p1, losses = pretrain_ddpm(TINY, steps=2, ref_size=32, batch=8, ckpt_path=ck, device=CPU)
    assert len(losses) == 2 and all(np.isfinite(losses))
    p2, losses2 = pretrain_ddpm(TINY, steps=2, ref_size=32, batch=8, ckpt_path=ck, device=CPU)
    assert losses2 == []                       # restored, not trained
    p3, _ = pretrain_ddpm(TINY, steps=2, ref_size=32, batch=8, device=CPU)
    for a, b, c in zip(tree_leaves(p1), tree_leaves(p2), tree_leaves(p3)):
        assert torch.equal(a, b) and torch.equal(a, c)
    from repro_torch.checkpoint import read_manifest
    meta = read_manifest(ck + ".npz")["metadata"]
    assert meta["schema"] == DDPM_CKPT_SCHEMA == "repro_torch.gen/ddpm-ckpt/v1"
    assert meta["pretrain"]["base_width"] == 8 and meta["final_loss"] == losses[-1]
    restored = load_pretrained(ck, TINY, device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored), tree_leaves(p1)))
    # another budget misses the checkpoint and trains
    _, losses4 = pretrain_ddpm(TINY, steps=3, ref_size=32, batch=8, ckpt_path=ck, device=CPU)
    assert len(losses4) == 3
    for bad in (DDPM(timesteps=16, num_classes=10, base_width=8),
                DDPM(timesteps=8, num_classes=10, base_width=16)):
        with pytest.raises(ValueError, match="does not match"):
            load_pretrained(ck, bad, device=CPU)
    from repro_torch.checkpoint import save_tree
    save_tree(str(tmp_path / "other"), p1, metadata={"schema": "repro.gen/ddpm-ckpt/v1"})
    with pytest.raises(ValueError, match="not a DDPM checkpoint"):
        load_pretrained(str(tmp_path / "other"), TINY, device=CPU)
    with pytest.raises(ValueError):
        pretrain_ddpm(DDPM(num_classes=7), steps=1, ref_size=8, device=CPU)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def _jax_noise(key, start, n, steps):
    """The JAX package's per-image draws of images start..start+n-1, in the
    port's noise layout [n, steps + 1, 32, 32, 3] (row = position tag)."""
    idx = jnp.arange(start, start + n, dtype=jnp.uint32)
    noise = jax.jit(jsampler._per_image_noise, static_argnums=3)
    return np.stack([np.asarray(noise(key, idx, jnp.int32(tag), (32, 32, 3)))
                     for tag in range(steps + 1)], axis=1)


def test_sample_schedule_matches_jax_with_injected_noise(unet_params):
    """The strided eta=1 sampler on the reference's noise: float64 against
    the JAX package's float64 pass, float32 against its float32 one."""
    tree, pt = unet_params
    labels = np.array([3, 3, 0, 7, 9, 1], np.int32)
    steps, n = 4, 6
    key = jservice.gen_round_key(5, 2)
    want32 = jsampler.sample_schedule(tree, J_TINY, key, labels, steps, start=3)
    got32 = sample_schedule(pt, TINY, None, labels, steps, start=3,
                            noise=_jax_noise(key, 3, n, steps))
    assert got32.shape == (n, 32, 32, 3) and got32.dtype == np.float32
    assert np.abs(got32 - want32).max() <= SAMPLE_TOL32, np.abs(got32 - want32).max()
    with jax.enable_x64(True):
        idx = jnp.arange(3, 3 + 8, dtype=jnp.uint32)
        want64 = np.asarray(jsampler._sample_strided(
            _to64(tree), J_TINY, key, jnp.asarray(np.pad(labels, (0, 2))), steps, idx))[:n]
        noise64 = _jax_noise(key, 3, n, steps)
    assert noise64.dtype == np.float64
    z = torch.zeros((steps + 1, 8, 3, 32, 32), dtype=torch.float64)
    z[:, :n] = torch.from_numpy(noise64).permute(1, 0, 4, 2, 3)
    got64 = _nhwc(_sample_strided(tree_map(lambda a: a.double(), pt), TINY,
                                  torch.from_numpy(np.pad(labels, (0, 2))).long(), steps, z))[:n]
    assert np.abs(got64 - want64).max() <= SAMPLE_TOL64, np.abs(got64 - want64).max()
    assert 0.05 < np.abs(want64).mean() and np.abs(want64).max() <= 1.0


def test_ddpm_sample_matches_jax_with_injected_noise(unet_params):
    """The full ancestral chain (`ddpm_sample`) on the JAX package's chain
    of draws: x_T from the first split, then one split per step."""
    tree, pt = unet_params
    labels = np.array([0, 4, 9], np.int32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jddpm.ddpm_sample(tree, J_TINY, key, labels))
    k, kx = jax.random.split(key)
    draws = [np.asarray(jax.random.normal(kx, (3, 32, 32, 3)))]
    for _ in range(TINY.timesteps):
        k, kn = jax.random.split(k)
        draws.append(np.asarray(jax.random.normal(kn, (3, 32, 32, 3))))
    got = ddpm_sample(pt, TINY, labels, noise=np.stack(draws))
    assert got.shape == (3, 32, 32, 3)
    assert np.abs(got - want).max() <= SAMPLE_TOL32, np.abs(got - want).max()
    own = ddpm_sample(pt, TINY, labels, rng=np.random.default_rng(0))
    assert np.isfinite(own).all() and np.abs(own).max() <= 1.0


def test_image_noise_is_keyed_per_image():
    key = gen_round_key(5, 2)
    block = image_noise(key, 3, 4, 2)
    assert block.shape == (4, 3, 32, 32, 3) and block.dtype == np.float32
    for j in range(4):
        assert np.array_equal(block[j], image_noise(key, 3 + j, 1, 2)[0])
    assert not np.array_equal(image_noise(gen_round_key(5, 3), 3, 1, 2), block[:1])
    assert not np.array_equal(image_noise(gen_round_key(6, 2), 3, 1, 2), block[:1])
    assert len({tuple(gen_round_key(s, t).generate_state(4)) for s in range(3)
                for t in range(3)}) == 9


@pytest.fixture(scope="module")
def tiny_params():
    return make_ddpm(np.random.default_rng(0), TINY, device=CPU)


def test_fused_equals_per_label_loop_and_shards_bitwise(tiny_params):
    """One fused pass over a multi-label schedule == the per-label loop ==
    offset shards, bit for bit on the CPU: every image's noise is keyed by
    its global schedule index, not its batch position."""
    key = gen_round_key(5, 2)
    counts = np.array([2, 0, 3, 1] + [0] * 6)     # includes an empty label
    labels = np.repeat(np.arange(10), counts).astype(np.int32)
    fused = sample_schedule(tiny_params, TINY, key, labels, 4)
    parts, off = [], 0
    for lab, c in enumerate(counts):
        if c:
            parts.append(sample_schedule(tiny_params, TINY, key, [lab] * int(c), 4, start=off))
            off += int(c)
    assert np.array_equal(fused, np.concatenate(parts))
    assert np.array_equal(fused[2:5], sample_schedule(tiny_params, TINY, key, labels[2:5], 4,
                                                      start=2))


def test_bucket_padding_is_bitwise_neutral(tiny_params):
    key = gen_round_key(1, 0)
    labels = [0, 1, 2, 3, 0, 1]
    a = sample_schedule(tiny_params, TINY, key, labels, 4, bucket=8)
    assert np.array_equal(a, sample_schedule(tiny_params, TINY, key, labels, 4, bucket=32))
    assert np.array_equal(a, sample_schedule(tiny_params, TINY, key, labels, 4))
    with pytest.raises(ValueError, match="bucket"):
        sample_schedule(tiny_params, TINY, key, labels, 4, bucket=4)
    assert sample_schedule(tiny_params, TINY, key, [], 4).shape == (0, 32, 32, 3)


def test_generator_schedule_conservation_and_round_keys(tiny_params):
    """The generator returns exactly the b* images of the label schedule
    (b = 0, b < num_classes, single label); the same (seed, round) gives the
    same images whatever the shared numpy stream holds, which it never
    consumes; another round gives others. `DDPMGenerator` is the same
    service at the full noise schedule unless strided."""
    gen = BatchedDDPMGenerator(tiny_params, TINY, seed=3, sampler_steps=2)
    rng = np.random.default_rng(0)
    for b in (0, 1, 3, 11):
        counts = label_schedule(b, TINY.num_classes)
        assert gen.generate(np.repeat(np.arange(10), counts), rng).shape == (b, 32, 32, 3)
    assert gen.generate(np.full(5, 2, np.int32), rng, round_idx=1).shape == (5, 32, 32, 3)
    labels = np.array([0, 1, 1, 2])
    state = rng.bit_generator.state
    a = gen.generate(labels, rng, round_idx=7)
    assert rng.bit_generator.state == state
    rng.normal(size=100)
    assert np.array_equal(a, gen.generate(labels, rng, round_idx=7))
    assert not np.array_equal(a, gen.generate(labels, rng, round_idx=8))
    wrapped = DDPMGenerator(tiny_params, TINY, seed=3, sampler_steps=2)
    assert np.array_equal(a, wrapped.generate(labels, rng, round_idx=7))
    assert DDPMGenerator(tiny_params, TINY)._inner.sampler_steps == TINY.timesteps


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
def test_calibration_roundtrip_cache_hit_and_foreign_file(tiny_params, monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    svc = calibrated_service(tiny_params, TINY, sampler_steps=2, bucket=4)
    assert isinstance(svc, MeasuredService)
    assert svc.t_per_image > 0 and svc.steps == 2 and svc.source == "measured"
    entries = load_calibration()
    assert list(entries) == ["cpu/cpu/8/10/8/2/4"]
    doc = json.loads((tmp_path / "torch_gen_calib.json").read_text())
    assert doc["schema"] == CALIB_SCHEMA == "repro_torch.gen/calib/v1"
    assert not (tmp_path / "gen_calib.json").exists()
    monkeypatch.setattr(calib, "measure_t_per_image",
                        lambda *a, **k: pytest.fail("measured again on a cache hit"))
    assert calibrated_service(tiny_params, TINY, sampler_steps=2, bucket=4) == svc
    save_calibration({"cpu/cpu/8/10/8/2/4": {"t_image": 0.25, "bucket": 4,
                                             "sampler_steps": 2}})
    assert calibrated_service(tiny_params, TINY, 2, bucket=4).t_per_image == 0.25
    (tmp_path / "torch_gen_calib.json").write_text(
        '{"schema": "repro.gen/calib/v1", "entries": {"cpu/cpu/8/10/8/2/4": {"t_image": 1}}}')
    assert load_calibration() == {}
    (tmp_path / "torch_gen_calib.json").write_text("{not json")
    assert load_calibration() == {}
