"""LM training in the port against the JAX package: the token stream, the
schedules and optimizers, `sdpa_chunked`, `lru_scan`, `chunked_xent`,
`loss_fn` and its gradient, and `make_train_step`.

The JAX side runs `impl="jnp"` (its Pallas kernels have no gradient), the
port `impl="torch"`, on the CPU. Weights made by the JAX package are
carried over with `repro_torch.convert.from_jax_params`, after every bias
and norm leaf is moved off its init value; inputs are made with numpy
from fixed seeds. Tolerances: schedules 2 float32 ulps; optimizer updates
1e-6 and three train steps 1e-5, relative to each leaf's largest value;
attention, scan and loss values 1e-5 x max(1, max|ref|); gradients, each
leaf's max error 1e-4 x max|g_ref|.
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.synthetic import batch_tokens as jax_batch_tokens
from repro.data.synthetic import make_token_dataset as jax_make_token_dataset
from repro.models import api as jax_api
from repro.models import transformer as jax_tfm
from repro.models import xlstm as jax_xl
from repro.models.attention import sdpa_chunked as jax_sdpa_chunked
from repro.models.rglru import lru_scan as jax_lru_scan
from repro.models.rglru import rglru_block as jax_rglru_block
from repro.optim import optimizers as jax_opt
from repro.optim import schedules as jax_sched
from repro_torch import optim
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import from_jax_params, jax_leaf_map
from repro_torch.data.synthetic import batch_tokens, make_token_dataset
from repro_torch.launch import train as launch_train
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.models import xlstm as xl
from repro_torch.models.attention import sdpa_chunked
from repro_torch.models.rglru import lru_scan, rglru_block
from repro_torch.tree import tree_leaves, tree_map

GRAD_TOL = 1e-4
VALUE_TOL = 1e-5
PERTURBED = {"bq", "bk", "bv", "scale", "bias", "b", "b_if"}
# one of each block kind: attention with GQA and qkv bias, local window and
# softcaps, RG-LRU, mLSTM and sLSTM, MoE with its aux loss, encoder-decoder,
# and llava's projector
FAMILIES = ["qwen1.5-0.5b", "gemma2-9b", "recurrentgemma-9b", "xlstm-1.3b",
            "olmoe-1b-7b", "whisper-tiny", "llava-next-mistral-7b"]


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


def _rel_close(got, want, tol, what=""):
    """max |got - want| <= tol x max |want| (a zero leaf must stay zero)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    limit = tol * float(np.abs(want).max())
    assert err <= limit, f"{what}: {err:.3e} > {limit:.3e}"


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Token data, schedules, optimizers
# ---------------------------------------------------------------------------
def test_token_dataset_and_batches_are_bitwise_the_reference():
    for vocab, n, seed in ((512, 5000, 0), (151936, 3000, 3)):
        toks = make_token_dataset(vocab, n, seed=seed)
        want = jax_make_token_dataset(vocab, n, seed=seed)
        assert toks.dtype == want.dtype and np.array_equal(toks, want)
        for step in (0, 1, 7):
            got, ref = batch_tokens(toks, 4, 33, step), jax_batch_tokens(want, 4, 33, step)
            assert set(got) == set(ref)
            for k in ref:
                assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


SCHEDULES = {
    "constant": lambda m: m.constant_schedule(3e-4),
    "cosine": lambda m: m.cosine_schedule(3e-4, 50, warmup=2),
    "cosine_no_warmup": lambda m: m.cosine_schedule(0.7, 13, final_frac=0.05),
    "wsd": lambda m: m.wsd_schedule(3e-4, 50, warmup=2),
    "wsd_long_decay": lambda m: m.wsd_schedule(1.0, 37, warmup=5, decay_frac=0.3,
                                               final_frac=0.02),
    "get_wsd": lambda m: m.get_schedule("wsd", 1e-3, 20, warmup=1),
    "get_cosine": lambda m: m.get_schedule("cosine", 1e-3, 20, warmup=1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    """Every step from 0 to total + 2, within 2 float32 ulps."""
    f, fj = SCHEDULES[name](optim), SCHEDULES[name](jax_sched)
    for step in range(53):
        got, want = f(step), np.float32(fj(step))
        assert isinstance(got, np.float32), type(got)
        ulps = abs(int(np.array(got).view(np.int32)) - int(np.array(want).view(np.int32)))
        assert ulps <= 2, (step, got, want)


def _grad_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.normal(size=(5, 7))).astype(np.float32),
            "b": [(scale * rng.normal(size=(3,))).astype(np.float32),
                  (scale * rng.normal(size=(2, 2, 4))).astype(np.float32)]}


OPTIMIZERS = {
    "sgd": lambda m, s: m.make_optimizer("sgd", s),
    "momentum": lambda m, s: m.make_optimizer("momentum", s, beta=0.8),
    "adamw": lambda m, s: m.make_optimizer("adamw", s),
    "adamw_wd": lambda m, s: m.make_optimizer("adamw", s, weight_decay=0.1),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_jax(name):
    """Four updates under a cosine schedule with warmup, on the same
    gradients; parameters and state within 1e-6 of each leaf's largest."""
    opt = OPTIMIZERS[name](optim, optim.cosine_schedule(0.05, 6, warmup=1))
    opt_j = OPTIMIZERS[name](jax_opt, jax_sched.cosine_schedule(0.05, 6, warmup=1))
    p_np = _grad_tree(0)
    params, params_j = tree_map(torch.from_numpy, p_np), jax.tree.map(jnp.asarray, p_np)
    state, state_j = opt.init(params), opt_j.init(params_j)
    for i in range(4):
        g = _grad_tree(10 + i)
        params, state = opt.update(tree_map(torch.from_numpy, g), state, params)
        params_j, state_j = opt_j.update(jax.tree.map(jnp.asarray, g), state_j, params_j)
        for got, want in zip(tree_leaves(params), jax.tree.leaves(params_j)):
            _rel_close(got.numpy(), want, 1e-6, f"step {i}")
        assert state["step"] == int(state_j["step"])
        for key in ("m", "v"):
            if key in state_j:
                for got, want in zip(tree_leaves(state[key]), jax.tree.leaves(state_j[key])):
                    _rel_close(got.numpy(), want, 1e-6, f"{key} step {i}")


def test_global_norm_and_clip_match_jax():
    """Scaled down (norm above the limit), left alone (below it), and all
    zeros, where the 1e-9 floor keeps the scale at 1."""
    for scale, max_norm in ((10.0, 1.0), (1e-3, 1.0), (0.0, 1.0), (1.0, 5.0)):
        g = _grad_tree(5, scale)
        got, gn = optim.clip_by_global_norm(tree_map(torch.from_numpy, g), max_norm)
        want, gn_j = jax_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
        assert abs(float(gn) - float(gn_j)) <= 1e-6 * max(float(gn_j), 1e-30)
        assert abs(float(optim.global_norm(tree_map(torch.from_numpy, g))) - float(gn_j)) \
            <= 1e-6 * max(float(gn_j), 1e-30)
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert np.all(np.isfinite(a.numpy()))
            _close(a.numpy(), b, 1e-6, f"scale {scale}")


# ---------------------------------------------------------------------------
# sdpa_chunked, lru_scan, the mLSTM's gradient
# ---------------------------------------------------------------------------
# (name, B, Sq, Skv, nq, nkv, hd, causal, window, softcap, kv_chunk, q_chunk, masked)
SDPA_CASES = [
    ("causal_gqa", 2, 24, 24, 4, 2, 16, True, None, None, 8, 16, False),
    ("window_softcap", 2, 30, 30, 4, 4, 8, True, 7, 5.0, 16, 512, False),
    ("skv_not_chunk_multiple", 1, 21, 45, 6, 2, 8, True, None, None, 16, 8, False),
    ("non_causal_mqa", 2, 17, 40, 4, 1, 16, False, None, 30.0, 16, 8, False),
    ("fully_masked_rows", 2, 12, 20, 2, 1, 8, True, 4, None, 8, 8, True),
]


@lru_cache(maxsize=None)
def _jax_sdpa(causal, window, softcap, kv_chunk, q_chunk):
    def f(q, k, v, qp, kp, w):
        out = jax_sdpa_chunked(q, k, v, qp, kp, causal=causal, window=window,
                               attn_softcap=softcap, kv_chunk=kv_chunk, q_chunk=q_chunk)
        return jnp.sum(out * w), out
    return jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))


@pytest.mark.parametrize("case", SDPA_CASES, ids=[c[0] for c in SDPA_CASES])
def test_sdpa_chunked_and_its_gradient_match_jax(case):
    """Output and the gradient of sum(out * w) to q, k, v. Sq and Skv are
    not chunk multiples in every case; "fully_masked_rows" has rows whose
    every slot is empty (-1) or outside the window, and kv padding."""
    _, B, Sq, Skv, nq, nkv, hd, causal, window, cap, kvc, qc, masked = case
    rng = np.random.default_rng(len(case[0]))
    q, w = (rng.normal(size=(B, Sq, nq, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, Skv, nkv, hd)).astype(np.float32) for _ in range(2))
    q_pos = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (B, Sq)).copy()
    kv_pos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    if masked:
        kv_pos[:, Skv // 2:] = -1          # empty slots; late rows see none in the window
    (_, out_j), grads_j = _jax_sdpa(causal, window, cap, kvc, qc)(
        *map(jnp.asarray, (q, k, v, q_pos, kv_pos, w)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = sdpa_chunked(qt, kt, vt, torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                       causal=causal, window=window, attn_softcap=cap, kv_chunk=kvc,
                       q_chunk=qc)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach().numpy(), out_j, VALUE_TOL, "out")
    for name, t, g in zip("qkv", (qt, kt, vt), grads_j):
        _rel_close(t.grad.numpy(), g, GRAD_TOL, f"d{name}")
    if masked:
        rows = np.where(((q_pos[0][:, None] - kv_pos[0][None]) < window)
                        & (kv_pos[0][None] >= 0)
                        & (q_pos[0][:, None] >= kv_pos[0][None]), 1, 0).sum(1) == 0
        assert rows.any(), "the case has no fully masked row"


def test_lru_scan_matches_jax():
    """lru_scan alone (a loop, against the JAX associative scan), and the
    RG-LRU block under impl="torch" from zeros and with h0 folded in,
    against the JAX block under impl="jnp". Within 1e-5 x max(1, max|h|);
    the float64 loop beside it shows float32 rounding is the whole gap."""
    rng = np.random.default_rng(8)
    la = -np.abs(rng.normal(size=(2, 50, 24))).astype(np.float32) * 0.2
    b = rng.normal(size=(2, 50, 24)).astype(np.float32)
    want = np.asarray(jax.jit(jax_lru_scan)(jnp.asarray(la), jnp.asarray(b)))
    got = lru_scan(torch.from_numpy(la), torch.from_numpy(b)).numpy()
    exact = lru_scan(torch.from_numpy(la).double(), torch.from_numpy(b).double()).numpy()
    _close(got, want, VALUE_TOL, "lru_scan")
    _close(want, exact, VALUE_TOL, "jax against float64")
    cfg_j, cfg, params_j, params, tree = model("recurrentgemma-9b")
    i = cfg.layer_kinds.index("rglru")
    pj = jax.tree.map(jnp.asarray, jax_leaf_map(cfg, tree)["layers"][i]["rec"])
    x = rng.normal(size=(2, 19, cfg.d_model)).astype(np.float32)
    w = cfg.lru_width or cfg.d_model
    st = {"h": rng.normal(size=(2, w)).astype(np.float32),
          "conv": rng.normal(size=(2, cfg.conv_kernel - 1, w)).astype(np.float32)}
    block_j = jax.jit(lambda p, x, s: jax_rglru_block(p, x, cfg_j, s, impl="jnp"))
    for state in (None, st):
        yj, sj = block_j(pj, jnp.asarray(x), None if state is None
                         else jax.tree.map(jnp.asarray, state))
        yt, s_t = rglru_block(params["layers"][i]["rec"], torch.from_numpy(x), cfg,
                              None if state is None else _t(state), impl="torch")
        _close(yt.numpy(), yj, VALUE_TOL, f"block, h0 {state is not None}")
        if state is not None:
            _close(s_t["h"].numpy(), sj["h"], VALUE_TOL, "h")


def test_mlstm_gradient_with_ties_matches_jax():
    """jax.grad of mlstm_seq against autograd, on inputs built to tie: log
    forget gates 0 and equal input gates over whole stretches, so the
    cummax of i - F and the max against the carried m tie. The output does
    not depend on the stabilizer, so how a tie's gradient is split moves
    it only by rounding."""
    B, S, H, hd = 2, 24, 2, 8
    rng = np.random.default_rng(9)
    q, k, v, w = (rng.normal(size=(B, S, H, hd)).astype(np.float32) * 0.5 for _ in range(4))
    it = np.repeat(rng.normal(size=(B, S // 6, H)), 6, axis=1).astype(np.float32)
    ft = np.zeros((B, S, H), np.float32)
    ft[:, S // 2:] = -0.1
    st = (rng.normal(size=(B, H, hd, hd)).astype(np.float32),
          rng.normal(size=(B, H, hd)).astype(np.float32),
          it[:, 0].copy())                              # m ties the first step's gate

    def f(q, k, v, it, ft):
        h, _ = jax_xl.mlstm_seq(q, k, v, it, ft, tuple(map(jnp.asarray, st)), chunk=8)
        return jnp.sum(h * w)
    grads_j = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (q, k, v, it, ft)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, it, ft)]
    h, _ = xl.mlstm_seq(*ts, {key: torch.from_numpy(a) for key, a in zip("Cnm", st)}, chunk=8)
    (h * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip(("q", "k", "v", "i", "f"), ts, grads_j):
        _rel_close(t.grad.numpy(), g, GRAD_TOL, f"d{name}")


# ---------------------------------------------------------------------------
# The loss and the train step
# ---------------------------------------------------------------------------
@lru_cache(maxsize=None)
def model(arch):
    """(JAX config, port config, JAX params, port params, numpy tree)."""
    cfg_j, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, jax_api.init_params(jax.random.PRNGKey(0), cfg_j))
    rng = np.random.default_rng(7)

    def move(path, a):
        if getattr(path[-1], "key", None) in PERTURBED:
            return a + (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a
    tree = jax.tree_util.tree_map_with_path(move, tree)
    return (cfg_j, cfg, jax.tree.map(jnp.asarray, tree),
            from_jax_params(cfg, tree, device="cpu"), tree)


def make_batch(cfg, B=2, S=24, seed=0):
    """tokens, targets and a mask with zeros, and the family's extras."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.modality == "vision":
        batch["patch_embeds"] = rng.normal(size=(B, cfg.frontend_tokens, 1024)).astype(np.float32)
    if cfg.modality == "audio":
        batch["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


@lru_cache(maxsize=None)
def jax_value_and_grad(arch):
    cfg_j = model(arch)[0]
    return jax.jit(jax.value_and_grad(jax_api.make_loss_fn(cfg_j, impl="jnp"), has_aux=True))


def port_value_and_grad(cfg, params, batch, **kw):
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, parts = api.make_loss_fn(cfg, **kw)(live, _t(batch))
    loss.backward()
    return loss.detach(), parts, [p.grad for p in tree_leaves(live)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradient_match_jax(arch):
    """ce, aux and every parameter's gradient against jax.value_and_grad of
    the JAX loss under impl="jnp"."""
    cfg_j, cfg, params_j, params, _ = model(arch)
    batch = make_batch(cfg)
    (loss_j, parts_j), grads_j = jax_value_and_grad(arch)(params_j, jax.tree.map(jnp.asarray, batch))
    loss, parts, grads = port_value_and_grad(cfg, params, batch)
    _close(loss.numpy(), loss_j, VALUE_TOL, "loss")
    for key in ("ce", "aux"):
        _close(parts[key].detach().numpy(), parts_j[key], VALUE_TOL, key)
    want = tree_leaves(jax_leaf_map(cfg, jax.tree.map(np.asarray, grads_j)))
    assert len(want) == len(grads)
    for i, (g, gj) in enumerate(zip(grads, want)):
        g = np.zeros_like(gj) if g is None else g.numpy()
        if not np.abs(gj).max():
            assert not np.abs(g).max(), f"leaf {i}: the reference's gradient is zero"
            continue
        _rel_close(g, gj, GRAD_TOL, f"leaf {i} {gj.shape}")


def test_chunked_xent_matches_jax():
    """S = 37 over chunks of 16 (the last chunk short) with a padded vocab
    (512 padded to 600, the 88 columns masked); value and its gradient to
    the hidden states and the tied embedding."""
    cfg_j = dataclasses.replace(model("qwen1.5-0.5b")[0], pad_vocab_multiple=100)
    cfg = dataclasses.replace(model("qwen1.5-0.5b")[1], pad_vocab_multiple=100)
    assert cfg.padded_vocab_size == 600
    tree = jax.tree.map(np.asarray, jax_api.init_params(jax.random.PRNGKey(1), cfg_j))
    rng = np.random.default_rng(12)
    B, S = 2, 37
    hidden = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    targets = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)

    def f(embed, h):
        return jax_tfm.chunked_xent({**tree, "embed": embed}, cfg_j, h, jnp.asarray(targets),
                                    jnp.asarray(mask), chunk=16)
    val_j, (ge_j, gh_j) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(tree["embed"]), jnp.asarray(hidden))
    params = from_jax_params(cfg, tree, device="cpu")
    embed = params["embed"].requires_grad_(True)
    h = torch.from_numpy(hidden).requires_grad_(True)
    val = tfm.chunked_xent({**params, "embed": embed}, cfg, h, torch.from_numpy(targets),
                           torch.from_numpy(mask), chunk=16)
    val.backward()
    _close(val.detach().numpy(), val_j, VALUE_TOL, "value")
    _rel_close(h.grad.numpy(), gh_j, GRAD_TOL, "d hidden")
    _rel_close(embed.grad.numpy(), ge_j, GRAD_TOL, "d embed")
    assert not embed.grad[cfg.vocab_size:].abs().max()


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "xlstm-1.3b"])
def test_three_adamw_steps_match_jax(arch):
    """make_train_step with AdamW (weight decay 0.01) under a cosine
    schedule with warmup, three steps on three batches: metrics and every
    parameter within 1e-5 of the leaf's largest value.

    eps is 1e-3. At the default 1e-8, Adam's first update of an element
    is about g / (|g| + eps), so where |g| is near eps its update follows
    the float32 rounding of g in either package: qwen's k bias, which RoPE
    leaves nearly free, has elements at |g| = 8e-11 whose gradients the
    two packages give 7x apart (2.8e-8 apart, 1.7e-6 of the leaf's
    largest, within GRAD_TOL), and their updates then differ by a
    fraction of lr. With eps 1e-3 an update moves by at most lr x 3e-5
    for that gradient error, so the comparison measures the port."""
    params, want, _ = three_adamw_steps(arch, eps=1e-3)
    for i, (p, pj) in enumerate(zip(tree_leaves(params), want)):
        _rel_close(p.numpy(), pj, 1e-5, f"leaf {i} {pj.shape}")


ADAMW_LR, ADAMW_WD = 3e-3, 0.01
# |m_hat / sqrt(v_hat)| <= sqrt(sum_i w_i^2 / u_i) over the first three
# steps at b1 0.9, b2 0.999 (w, u: the bias-corrected weights of each
# step's gradient in m_hat and v_hat); 1.0027 at step 2
ADAM_DIRECTION_MAX = 1.01
# at eps 1e-8 an update is about g / |g|, so a gradient error d moves it by
# about lr x d / |g|. The packages' gradients agree to 3.2e-6 (qwen) and
# 5.8e-6 (xlstm) of each leaf's largest, and elements whose gradient falls
# to 1e-4 of it (qwen) or 3e-4 (xlstm) at some step miss 1e-5
LOOSE_GRAD = 1e-3


def three_adamw_steps(arch, eps):
    """Three make_train_step steps with AdamW (weight decay 0.01) under a
    cosine schedule with warmup, on three batches, in both packages; the
    metrics of each step within VALUE_TOL. Returns (port params, JAX
    params in the port's leaf order, [(lr, JAX gradients in the port's
    leaf order)] of each step)."""
    cfg_j, cfg, params_j, params, _ = model(arch)
    sched = dict(lr=ADAMW_LR, total_steps=3, warmup=1)
    kw = dict(weight_decay=ADAMW_WD, eps=eps)
    opt = optim.make_optimizer("adamw", optim.cosine_schedule(**sched), **kw)
    opt_j = jax_opt.make_optimizer("adamw", jax_sched.cosine_schedule(**sched), **kw)
    step = api.make_train_step(cfg, opt)
    step_j = jax.jit(jax_api.make_train_step(cfg_j, opt_j, impl="jnp"))
    state, state_j = opt.init(params), opt_j.init(params_j)
    steps = []
    for s in range(3):
        batch = make_batch(cfg, seed=20 + s)
        batch_j = jax.tree.map(jnp.asarray, batch)
        _, grads_j = jax_value_and_grad(arch)(params_j, batch_j)
        steps.append((float(optim.cosine_schedule(**sched)(s)),
                      tree_leaves(jax_leaf_map(cfg, jax.tree.map(np.asarray, grads_j)))))
        params, state, m = step(params, state, _t(batch))
        params_j, state_j, m_j = step_j(params_j, state_j, batch_j)
        for key in ("loss", "ce", "aux", "grad_norm"):
            _close(m[key].numpy(), m_j[key], VALUE_TOL, f"step {s} {key}")
    want = tree_leaves(jax_leaf_map(cfg, jax.tree.map(np.asarray, params_j)))
    return params, want, steps


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "xlstm-1.3b"])
def test_three_adamw_steps_at_default_eps_match_jax(arch):
    """The train step as the launcher runs it, eps 1e-8. An element whose
    reference gradient fell below LOOSE_GRAD x its leaf's largest at some
    step has an update direction set by rounding (see the eps-1e-3 test),
    so it is held to the update bound alone: each step moves it by at most
    lr x (ADAM_DIRECTION_MAX + wd x |p|) in either package. Every other
    element stays within 1e-5 of its leaf's largest value."""
    params, want, steps = three_adamw_steps(arch, eps=1e-8)
    n_loose = 0
    for i, (p, pj) in enumerate(zip(tree_leaves(params), want)):
        p = p.numpy()
        loose = np.zeros(pj.shape, bool)
        for _, grads in steps:
            g = grads[i]
            loose |= np.abs(g) < LOOSE_GRAD * np.abs(g).max()
        n_loose += int(loose.sum())
        err = np.abs(p - pj)
        tight = err[~loose].max(initial=0.0)
        assert tight <= 1e-5 * np.abs(pj).max(), f"leaf {i} {pj.shape}: {tight:.3e}"
        bound = sum(2 * lr * (ADAM_DIRECTION_MAX + ADAMW_WD * np.abs(pj[loose]))
                    for lr, _ in steps)
        assert np.all(err[loose] <= bound), f"leaf {i} {pj.shape}: past the update bound"
    assert n_loose < sum(p.numel() for p in tree_leaves(params)) // 5


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b", "whisper-tiny"])
def test_remat_is_bitwise_on_the_cpu(arch):
    """remat=True recomputes each layer in backward: the loss and every
    gradient equal remat=False bit for bit."""
    _, cfg, _, params, _ = model(arch)
    batch = make_batch(cfg, seed=3)
    plain = port_value_and_grad(cfg, params, batch)
    remat = port_value_and_grad(cfg, params, batch, remat=True)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(plain[2], remat[2]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_kernel_training_raises():
    cfg = get_config("qwen1.5-0.5b").reduced()
    opt = optim.make_optimizer("adamw", optim.constant_schedule(1e-3))
    with pytest.raises(NotImplementedError, match="reference defect 6"):
        api.make_train_step(cfg, opt, impl="kernel")


@pytest.mark.parametrize("arch", list_archs())
def test_launcher_trains_every_family_on_the_cpu(arch):
    """Three launcher steps of each of the ten families, reduced: finite
    losses and parameters, every parameter moved by the optimizer."""
    before = api.init_params(torch.Generator().manual_seed(0), get_config(arch).reduced(),
                             device="cpu")
    params, losses = launch_train.train(arch, steps=3, batch=2, seq=16, log_every=10,
                                        device="cpu")
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    for a, b in zip(tree_leaves(before), tree_leaves(params)):
        assert torch.isfinite(b).all()
    moved = sum(bool((a != b).any()) for a, b in zip(tree_leaves(before), tree_leaves(params)))
    assert moved == len(tree_leaves(params))
