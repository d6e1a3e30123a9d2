"""The port's xLSTM (xlstm-1.3b: mLSTM and sLSTM blocks) against the JAX
package.

Weights made by the JAX package are carried over with
`repro_torch.convert.from_jax_params` after every bias and norm leaf is
moved off its init value; states cross between the packages with
`convert.cell_state_{from,to}_jax`; inputs are made with numpy from fixed
seeds. The model is `xlstm-1.3b`'s `.reduced()` (one mLSTM and one sLSTM
layer, d_model 256, 4 heads of 128). Tolerances: cells, blocks and layers
1e-5 x max(1, max|ref|), logits 1e-4 x max(1, max|logit|) as in
tests/test_torch_families.py; the port's chunkwise mLSTM against its own
recurrent cell 1e-4 x max(1, max|h|), as tests/test_kernels.py holds the
reference's.
"""
import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import api as jax_api
from repro.models import transformer as jax_tfm
from repro.models import xlstm as jax_xl
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import (cell_state_from_jax, cell_state_to_jax, from_jax_params,
                                 jax_leaf_map)
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.models import xlstm as xl
from repro_torch.serve import Request, ServeEngine
from repro_torch.tree import tree_leaves

ARCH = "xlstm-1.3b"
TOL = 1e-5
PERTURBED = {"scale", "bias", "b", "b_if"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    limit = tol * max(1.0, float(np.abs(want).max()))
    assert err <= limit, f"{what}: {err:.3e} > {limit:.3e}"


@lru_cache(maxsize=None)
def model():
    """(JAX config, port config, JAX params, port params, numpy tree)."""
    cfg_j, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray, jax_api.init_params(jax.random.PRNGKey(0), cfg_j))
    rng = np.random.default_rng(7)

    def move(path, a):
        if getattr(path[-1], "key", None) in PERTURBED:
            return a + (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a
    tree = jax.tree_util.tree_map_with_path(move, tree)
    return cfg_j, cfg, jax.tree.map(jnp.asarray, tree), from_jax_params(cfg, tree, device="cpu"), tree


def _cell_inputs(B, S, H, hd, seed, state=True):
    """q, k, v [B,S,H,hd] (q, k scaled as mlstm_block scales them), input
    gates, log forget gates [B,S,H], and a carried-in (C, n, m) state."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(3))
    q, k = q * hd ** -0.5, k * hd ** -0.5
    it = rng.normal(size=(B, S, H)).astype(np.float32)
    ft = np.log(1 / (1 + np.exp(-(rng.normal(size=(B, S, H)) + 3.0)))).astype(np.float32)
    st = (rng.normal(size=(B, H, hd, hd)).astype(np.float32) * state,
          rng.normal(size=(B, H, hd)).astype(np.float32) * state,
          rng.normal(size=(B, H)).astype(np.float32) * state)
    return (q, k, v, it, ft), st


def _cell_dict(st):
    return {key: torch.from_numpy(a) for key, a in zip(("C", "n", "m"), st)}


# ---------------------------------------------------------------------------
# Cells and blocks
# ---------------------------------------------------------------------------
def test_mlstm_cell_step_matches_jax():
    (q, k, v, it, ft), st = _cell_inputs(3, 1, 4, 16, seed=1)
    (Cj, nj, mj), hj = jax_xl._mlstm_cell_step(
        tuple(map(jnp.asarray, st)), tuple(jnp.asarray(a[:, 0]) for a in (q, k, v, it, ft)))
    new, ht = xl._mlstm_cell_step(_cell_dict(st), *(torch.from_numpy(a[:, 0])
                                                     for a in (q, k, v, it, ft)))
    _close(ht.numpy(), hj, TOL, "h")
    for key, want in zip(("C", "n", "m"), (Cj, nj, mj)):
        _close(new[key].numpy(), want, TOL, key)


@pytest.mark.parametrize("chunk", [8, 16, 37])
def test_mlstm_seq_matches_jax(chunk):
    """S = 37: chunks of 8 and 16 pad the last chunk (i = -1e30, log f =
    0), 37 is one chunk; with a carried-in state and from zeros."""
    for with_state in (True, False):
        xs, st = _cell_inputs(2, 37, 4, 16, seed=2, state=with_state)
        hj, (Cj, nj, mj) = jax_xl.mlstm_seq(*map(jnp.asarray, xs),
                                            tuple(map(jnp.asarray, st)), chunk=chunk)
        ht, new = xl.mlstm_seq(*map(torch.from_numpy, xs), _cell_dict(st), chunk=chunk)
        _close(ht.numpy(), hj, TOL, f"h chunk {chunk} state {with_state}")
        for key, want in zip(("C", "n", "m"), (Cj, nj, mj)):
            _close(new[key].numpy(), want, TOL, f"{key} chunk {chunk}")


def test_mlstm_seq_equals_its_recurrent_cell():
    """The port's chunkwise form (chunk 8 over 37 steps) against its own
    cell stepped 37 times, from a carried-in state."""
    xs, st = _cell_inputs(2, 37, 4, 16, seed=3)
    ts = [torch.from_numpy(a) for a in xs]
    h_seq, new = xl.mlstm_seq(*ts, _cell_dict(st), chunk=8)
    state, hs = _cell_dict(st), []
    for t in range(37):
        state, h = xl._mlstm_cell_step(state, *(a[:, t] for a in ts))
        hs.append(h)
    _close(h_seq.numpy(), torch.stack(hs, 1).numpy(), 1e-4, "h")
    # the stabilizers agree, so the states compare directly
    for key in ("C", "n", "m"):
        _close(new[key].numpy(), state[key].numpy(), 1e-4, key)


def test_slstm_block_matches_jax():
    """The sequential sLSTM over 21 steps from zeros and from a carried-in
    state, and one decode step."""
    cfg_j, cfg, params_j, params, _ = model()
    i = cfg.layer_kinds.index("slstm")
    pj = jax.tree.map(lambda a: a[0], params_j["groups"][i]["cell"])    # group 0
    pt = params["layers"][i]["cell"]
    rng = np.random.default_rng(4)
    inner = int(cfg.d_model * cfg.proj_factor)
    for S in (21, 1):
        x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
        st = tuple(rng.normal(size=(2, inner)).astype(np.float32) for _ in range(4))
        st = (st[0], np.abs(st[1]) + 0.5, st[2], st[3])
        for carried in (None, st):
            yj, sj = jax_xl.slstm_block(pj, jnp.asarray(x), cfg_j,
                                        None if carried is None else tuple(map(jnp.asarray, carried)))
            yt, s_t = xl.slstm_block(pt, torch.from_numpy(x), cfg,
                                     None if carried is None else
                                     cell_state_from_jax("slstm", carried, device="cpu"))
            _close(yt.numpy(), yj, TOL, f"y S={S}")
            for got, want, key in zip(cell_state_to_jax("slstm", s_t), sj, "cnmh"):
                _close(got, want, TOL, f"{key} S={S}")


# ---------------------------------------------------------------------------
# Layers and the model
# ---------------------------------------------------------------------------
def test_layers_match_jax():
    """Each layer alone: a prefill of 12 into a fresh state, then one
    decode step on that state; output and every state tensor within 1e-5."""
    cfg_j, cfg, _, params, tree = model()
    layers_np = jax_leaf_map(cfg, tree)["layers"]
    rng = np.random.default_rng(11)
    B = 2
    for i, kind in enumerate(cfg.layer_kinds):
        init_j = jax_xl.init_mlstm_state if kind == "mlstm" else jax_xl.init_slstm_state
        init_t = xl.init_mlstm_state if kind == "mlstm" else xl.init_slstm_state
        cj = {"cell": init_j(cfg_j, B)}
        ct = {"cell": init_t(cfg, B, torch.float32, "cpu")}
        pj = jax.tree.map(jnp.asarray, layers_np[i])
        for S, start in ((12, 0), (1, 12)):
            x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
            pos = np.broadcast_to(np.arange(start, start + S, dtype=np.int32), (B, S)).copy()
            yj, cj, _ = jax_tfm._apply_layer(pj, jnp.asarray(x), cfg_j, kind, jnp.asarray(pos),
                                             cj, impl="jnp", kv_chunk=1024, cross=False,
                                             decode=S == 1, long_window=None)
            yt, ct, _ = tfm._apply_layer(params["layers"][i], torch.from_numpy(x), cfg, kind,
                                         torch.from_numpy(pos), ct)
            _close(yt.numpy(), yj, TOL, f"layer {i} ({kind}) S={S}")
            for got, want, key in zip(cell_state_to_jax(kind, ct["cell"]), cj["cell"], range(4)):
                _close(got, want, TOL, f"layer {i} ({kind}) S={S} state {key}")


def test_forward_logits_match_jax():
    cfg_j, cfg, params_j, params, _ = model()
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 40))
    lj, _, _ = jax_tfm.forward(params_j, cfg_j, {"tokens": jnp.asarray(toks)})
    lt, _, _ = tfm.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    _close(lt.numpy(), lj, 1e-4, "logits")


def test_greedy_generate_matches_jax():
    """Prefill of 300 tokens (two mLSTM chunks of 256) and 8 greedy decode
    steps: the port's step logits against the JAX package's on the JAX
    tokens, and both packages' `greedy_generate`."""
    cfg_j, cfg, params_j, params, _ = model()
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(2, 300))
    want = np.asarray(jax_api.greedy_generate(cfg_j, params_j, jnp.asarray(prompt), 8))
    got = api.greedy_generate(cfg, params, torch.from_numpy(prompt), 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    cj, ct = jax_api.init_cache(cfg_j, 2, 308), api.init_cache(cfg, 2, 308, device="cpu")
    lj, cj = jax.jit(jax_api.make_prefill_step(cfg_j))(params_j, cj, {"tokens": jnp.asarray(prompt)})
    lt, ct = api.make_prefill_step(cfg)(params, ct, {"tokens": torch.from_numpy(prompt)})
    dec_j, dec_t = jax.jit(jax_api.make_decode_step(cfg_j)), api.make_decode_step(cfg)
    for i in range(8):
        _close(lt.numpy(), lj, 1e-4, f"step {i}")
        tok = np.array(want[:, i:i + 1])
        pos = np.full((2, 1), 300 + i, np.int32)
        lj, cj = dec_j(params_j, cj, jnp.asarray(tok, jnp.int32), jnp.asarray(pos))
        lt, ct = dec_t(params, ct, torch.from_numpy(tok), torch.from_numpy(pos))


def test_serve_tokens_match_jax():
    """Five requests through both engines with two slots, so lanes are
    reused and every new prefill replaces a lane's whole recurrent state;
    the tokens must equal the JAX engine's and the port's isolated
    generation of each request."""
    cfg_j, cfg, params_j, params, _ = model()
    rng = np.random.default_rng(3)
    mix = [(7, 5), (30, 4), (5, 6), (19, 3), (11, 5)]
    prompts = [rng.integers(0, cfg.vocab_size, size=p) for p, _ in mix]
    eng_j = JaxServeEngine(cfg_j, params_j, slots=2, max_len=64)
    eng_t = ServeEngine(cfg, params, slots=2, max_len=64, device="cpu")
    reqs_j = [JaxRequest(i, p, max_new_tokens=n) for i, (p, (_, n)) in enumerate(zip(prompts, mix))]
    reqs_t = [Request(i, p, max_new_tokens=n) for i, (p, (_, n)) in enumerate(zip(prompts, mix))]
    for rj, rt in zip(reqs_j, reqs_t):
        eng_j.submit(rj)
        eng_t.submit(rt)
    assert len(eng_j.run()) == len(eng_t.run()) == len(mix)
    for rj, rt in zip(reqs_j, reqs_t):
        assert rt.out == [int(t) for t in rj.out], rt.rid
        alone = api.greedy_generate(cfg, params, torch.as_tensor(rt.prompt)[None],
                                    rt.max_new_tokens, max_len=64, device="cpu")
        assert rt.out == alone[0].tolist(), rt.rid


# ---------------------------------------------------------------------------
# Config and full-size shapes
# ---------------------------------------------------------------------------
def test_config_matches_jax_and_param_count_is_pinned():
    """The config, reduced and full, field for field; `param_count()`
    keeps the reference's formula, which misses most of the mLSTM
    projections (ROADMAP.md Queue 3, reference defect 12)."""
    for reduce in (False, True):
        cj, ct = jax_get_config(ARCH), get_config(ARCH)
        if reduce:
            cj, ct = cj.reduced(), ct.reduced()
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        assert ct.layer_kinds == cj.layer_kinds
        assert ct.is_recurrent_decode and cj.is_recurrent_decode
        assert ct.param_count() == cj.param_count()
        assert ct.active_param_count() == cj.active_param_count()
    assert get_config(ARCH).param_count() == 1_915_160_576


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_full_size_param_shapes_match_jax():
    """At full size (48 layers, 6 groups of 8), neither side allocating:
    `jax.eval_shape` of the JAX init through the converter's leaf map
    against the port's init on the meta device: 3,628,908,880 parameters."""
    cfg_j, cfg = jax_get_config(ARCH), get_config(ARCH)
    shapes_j = jax.eval_shape(partial(jax_api.init_params, cfg=cfg_j), jax.random.PRNGKey(0))
    carried = jax_leaf_map(cfg, shapes_j,
                           row=lambda s, g: jax.ShapeDtypeStruct(s.shape[1:], s.dtype))
    own = tfm.init_params(None, cfg, device="meta")
    assert _shapes(own) == _shapes(carried)
    n_own = sum(t.numel() for t in tree_leaves(own))
    assert n_own == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes_j))
    assert n_own == 3_628_908_880


def test_state_dtypes_and_lane_sizes():
    """C, n, m and the sLSTM state stay fp32 under bf16 weights; conv
    takes the weights' dtype. At full size one lane holds 675 MiB."""
    cfg = get_config(ARCH)
    cache = api.init_cache(cfg, 1, 16, torch.bfloat16, device="meta")
    for kind, layer in zip(cfg.layer_kinds, cache["layers"]):
        for key, t in layer["cell"].items():
            assert t.dtype == (torch.bfloat16 if key == "conv" else torch.float32), (kind, key)
    lane = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
    assert 670 * 2 ** 20 < lane < 680 * 2 ** 20, lane / 2 ** 20
