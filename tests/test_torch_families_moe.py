"""The port's MoE layer (olmoe-1b-7b, grok-1-314b) against the JAX package.

Router, dense mode (experts accumulated in index order), sorted mode
(capacity ceil(T*k*cf/E), stable sort, drop on overflow), the n_groups
split and the `sorted_grouped` group rule, each with its load-balance aux
loss, and the whole reduced model under each mode. Weights come from the
JAX package through `from_jax_params`; inputs from numpy seeds.

`jax.lax.top_k` and `torch.topk` may order tied probabilities
differently, so every router input here is checked to have a nonzero
margin between the k-th and (k+1)-th expert of every token
(`_assert_topk_margin`), larger than float32 rounding of the
probabilities.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import moe as jax_moe
from repro.models import transformer as jax_tfm
from repro_torch.convert import jax_leaf_map
from repro_torch.models import api
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from test_torch_families import _logit_tol, model

MOE_ARCHS = ["olmoe-1b-7b", "grok-1-314b"]
MODES = ["dense", "sorted", "sorted_grouped"]
LAYER_TOL = 1e-5
MARGIN = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _moe_params(arch, layer=0):
    """(JAX config, port config, JAX moe params, port moe params)."""
    cfg_j, cfg, _, params, tree = model(arch)
    p_np = jax_leaf_map(cfg, tree)["layers"][layer]["moe"]
    return cfg_j, cfg, jax.tree.map(jnp.asarray, p_np), params["layers"][layer]["moe"]


def _assert_topk_margin(p, x, cfg):
    """Every token's k-th and (k+1)-th router probabilities differ by more
    than MARGIN, so both top-k implementations pick the same experts."""
    probs = torch.softmax((x.reshape(-1, x.shape[-1]) @ p["router"]).float(), -1)
    top = torch.topk(probs, cfg.moe.experts_per_token + 1, dim=-1).values
    margin = float((top[:, -2] - top[:, -1]).min())
    assert margin > MARGIN, f"top-k margin {margin:.3e}"
    return margin


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).normal(size=shape + (cfg.d_model,)).astype(np.float32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_topk_matches_jax(arch):
    cfg_j, cfg, pj, pt = _moe_params(arch)
    x = _x(cfg, (96,), 1)
    _assert_topk_margin(pt, torch.from_numpy(x), cfg)
    cj, ij, aj = jax_moe.router_topk(pj, jnp.asarray(x), cfg_j)
    ct, it, at = moe.router_topk(pt, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert np.abs(ct.numpy() - np.asarray(cj)).max() < LAYER_TOL
    assert abs(float(at) - float(aj)) < LAYER_TOL
    assert float(at) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_moe_modes_match_jax(arch, mode):
    """The layer under each mode, output and aux loss within 1e-5; dense
    and sorted agree with each other where nothing overflows capacity."""
    cfg_j, cfg, pj, pt = _moe_params(arch)
    x = _x(cfg, (2, 24), 2)
    _assert_topk_margin(pt, torch.from_numpy(x), cfg)
    yj, aj = jax_moe.moe(pj, jnp.asarray(x), cfg_j, mode=mode)
    yt, at = moe.moe(pt, torch.from_numpy(x), cfg, mode=mode)
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < LAYER_TOL
    assert abs(float(at) - float(aj)) < LAYER_TOL


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("n_groups,cf", [(1, 0.5), (2, 1.25), (3, 0.5), (5, 1.25)])
def test_moe_sorted_groups_and_drops_match_jax(arch, n_groups, cf):
    """`moe_sorted` with dispatch groups and a capacity that overflows
    (cf 0.5 drops some (token, expert) pairs, which keep only the residual
    path): the drops follow the stable sort order in both packages. 5 does
    not divide 48 tokens, so that case falls back to one group."""
    cfg_j, cfg, pj, pt = _moe_params(arch)
    x = _x(cfg, (2, 24), 3)
    _assert_topk_margin(pt, torch.from_numpy(x), cfg)
    yj, aj = jax_moe.moe_sorted(pj, jnp.asarray(x), cfg_j, capacity_factor=cf,
                                n_groups=n_groups)
    yt, at = moe.moe_sorted(pt, torch.from_numpy(x), cfg, capacity_factor=cf,
                            n_groups=n_groups)
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < LAYER_TOL
    assert abs(float(at) - float(aj)) < LAYER_TOL
    dense, _ = moe.moe_dense(pt, torch.from_numpy(x), cfg)
    dropped = float((yt - dense).abs().max()) > 1e-4
    assert dropped == (cf < 1.0), "cf 0.5 must drop, cf 1.25 must not at this size"


def test_sorted_grouped_group_rule_matches_jax():
    """4096 tokens: the rule takes 2 groups of 2048 (the largest count
    leaving at least 2048 a group); at 48 tokens it takes one."""
    assert moe.sorted_groups(4096) == 2 and moe.sorted_groups(48) == 1
    assert moe.sorted_groups(64 * 2048) == 64 and moe.sorted_groups(3 * 2048) == 2
    assert moe.sorted_groups(4097) == 1
    cfg_j, cfg, pj, pt = _moe_params("olmoe-1b-7b")
    x = _x(cfg, (2, 2048), 4)
    _assert_topk_margin(pt, torch.from_numpy(x), cfg)
    yj, aj = jax_moe.moe(pj, jnp.asarray(x), cfg_j, mode="sorted_grouped")
    yt, at = moe.moe(pt, torch.from_numpy(x), cfg, mode="sorted_grouped")
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < LAYER_TOL
    assert abs(float(at) - float(aj)) < LAYER_TOL
    two, _ = moe.moe_sorted(pt, torch.from_numpy(x), cfg, n_groups=2)
    assert torch.equal(yt, two)
    # where capacity binds, each group has its own: two groups drop other
    # pairs than one
    tight = [moe.moe_sorted(pt, torch.from_numpy(x), cfg, capacity_factor=0.5, n_groups=g)[0]
             for g in (1, 2)]
    assert float((tight[0] - tight[1]).abs().max()) > 1e-4


@pytest.fixture
def moe_mode():
    """Sets both packages' module-level MoE mode; restores dense."""
    def set_mode(mode):
        jax_tfm.set_moe_mode(mode)
        tfm.set_moe_mode(mode)
    yield set_mode
    set_mode("dense")


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_model_under_moe_mode_matches_jax(arch, mode, moe_mode, monkeypatch):
    """The whole reduced model under each mode: full-sequence logits and
    the summed aux loss (router_aux_loss x aux per layer), then prefill
    plus 3 decode steps. The JAX side runs eagerly, so the mode set here
    is the one its layers read. Every router call of the port asserts its
    top-k margin on the hidden states it is given."""
    moe_mode(mode)
    router = moe.router_topk
    margins = []

    def checked(p, x, cfg):
        margins.append(_assert_topk_margin(p, x, cfg))
        return router(p, x, cfg)
    monkeypatch.setattr(moe, "router_topk", checked)
    cfg_j, cfg, params_j, params, _ = model(arch)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 16))
    lj, _, aj = jax_tfm.forward(params_j, cfg_j, {"tokens": jnp.asarray(toks)}, impl="pallas")
    lt, _, at = tfm.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    lj = np.asarray(lj)
    assert np.abs(lt.numpy() - lj).max() < _logit_tol(lj)
    assert abs(float(at) - float(aj)) < LAYER_TOL and float(at) > 0

    from repro.models import api as jax_api
    cj = jax_api.init_cache(cfg_j, 2, 32)
    ct = api.init_cache(cfg, 2, 32, device="cpu")
    jpre = jax_api.make_prefill_step(cfg_j, impl="pallas")
    jdec = jax_api.make_decode_step(cfg_j, impl="pallas")
    lj, cj = jpre(params_j, cj, {"tokens": jnp.asarray(toks[:, :12])})
    lt, ct = api.make_prefill_step(cfg)(params, ct, {"tokens": torch.from_numpy(toks[:, :12])})
    dec = api.make_decode_step(cfg)
    for t in range(12, 15):
        lj = np.asarray(lj)
        assert np.abs(lt.numpy() - lj).max() < _logit_tol(lj), t
        pos = np.full((2, 1), t, np.int32)
        lj, cj = jdec(params_j, cj, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        lt, ct = dec(params, ct, torch.from_numpy(toks[:, t:t + 1]), torch.from_numpy(pos))
    lj = np.asarray(lj)
    assert np.abs(lt.numpy() - lj).max() < _logit_tol(lj)
    assert len(margins) == 5 * cfg.num_layers
