"""The port's attention LM families against the JAX package.

Eight architectures: qwen1.5-0.5b (qkv bias), gemma-2b (MQA, hd 256),
gemma2-9b (local/global, both softcaps), minicpm-2b (36-head MHA at full
size), llava-next-mistral-7b (vision projector, untied head), whisper-tiny
(encoder-decoder, layernorm, cross attention), olmoe-1b-7b and grok-1-314b
(MoE; their modes are held in test_torch_families_moe.py).

Weights made by the JAX package are carried over with
`repro_torch.convert.from_jax_params`, after every bias and norm leaf is
moved off its init value (zeros and ones would hide the qkv bias and the
norm parameters); inputs are made with numpy from fixed seeds. The JAX
side runs `impl="pallas"` (interpret mode on the CPU), the port runs on
the CPU, where its kernel wrappers take their plain versions. Models are
each family's `.reduced()`. Tolerances: layers and encoder outputs 1e-5,
logits 1e-4 x max(1, max|logit|), as tests/test_torch_serve.py.
"""
import dataclasses
import warnings
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import api as jax_api
from repro.models import transformer as jax_tfm
from repro.models.attention import init_kv_cache as jax_init_kv_cache
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import from_jax_params, jax_leaf_map
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import init_kv_cache
from repro_torch.serve import Request, ServeEngine
from repro_torch.tree import tree_leaves

ARCHS = ["qwen1.5-0.5b", "gemma-2b", "gemma2-9b", "minicpm-2b",
         "llava-next-mistral-7b", "whisper-tiny", "olmoe-1b-7b", "grok-1-314b"]
SERVED = [a for a in ARCHS if a != "whisper-tiny"]
LAYER_TOL = 1e-5
PERTURBED = {"bq", "bk", "bv", "scale", "bias"}


def _logit_tol(logits):
    return 1e-4 * max(1.0, float(np.abs(logits).max()))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _perturb(tree, seed=7):
    rng = np.random.default_rng(seed)

    def move(path, a):
        if getattr(path[-1], "key", None) in PERTURBED:
            return a + (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(move, tree)


@lru_cache(maxsize=None)
def model(arch, cfg_j=None, cfg=None):
    """(JAX config, port config, JAX params, port params, numpy tree)."""
    cfg_j = cfg_j or jax_get_config(arch).reduced()
    cfg = cfg or get_config(arch).reduced()
    tree = _perturb(jax.tree.map(np.asarray, jax_api.init_params(jax.random.PRNGKey(0), cfg_j)))
    return (cfg_j, cfg, jax.tree.map(jnp.asarray, tree),
            from_jax_params(cfg, tree, device="cpu"), tree)


@lru_cache(maxsize=None)
def jax_steps(cfg_j, long_window=None):
    kw = dict(impl="pallas", long_window=long_window)
    return (jax.jit(jax_api.make_prefill_step(cfg_j, **kw)),
            jax.jit(jax_api.make_decode_step(cfg_j, **kw)))


def _extras(cfg, B, seed):
    """The non-token inputs a family's prefill takes: llava's patch
    embeddings, whisper's frames."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "vision":
        return {"patch_embeds": rng.normal(size=(B, cfg.frontend_tokens, 1024)).astype(np.float32)}
    if cfg.modality == "audio":
        return {"frames": rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    return {}


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err < tol, f"{what}: {err:.3e} >= {tol:.3e}"


# ---------------------------------------------------------------------------
# Configs and parameter shapes
# ---------------------------------------------------------------------------
def test_registry_resolves_the_nine_and_refuses_xlstm():
    """The registry now resolves the ten architectures of the JAX package,
    xlstm-1.3b included (held in tests/test_torch_xlstm.py); the name is
    kept from when xlstm-1.3b was refused. An unknown name raises
    KeyError."""
    assert list_archs() == jax_list_archs()
    assert sorted(list_archs()) == sorted(ARCHS + ["recurrentgemma-9b", "xlstm-1.3b"])
    for arch in list_archs():
        assert get_config(arch).name == arch
        assert get_config(arch).is_recurrent_decode == jax_get_config(arch).is_recurrent_decode
        assert get_config(arch).active_param_count() == jax_get_config(arch).active_param_count()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("xlstm-7b")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    for reduce in (False, True):
        cj, ct = jax_get_config(arch), get_config(arch)
        if reduce:
            cj, ct = cj.reduced(), ct.reduced()
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        assert ct.layer_kinds == cj.layer_kinds
        assert ct.padded_vocab_size == cj.padded_vocab_size
        assert ct.is_encdec == cj.is_encdec
        assert ct.param_count() == cj.param_count()
    if arch == "gemma2-9b":
        assert get_config(arch).param_count() == 9_241_404_928


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_param_shapes_match_jax(arch):
    """At full size, neither side allocating: the JAX init's shapes from
    `jax.eval_shape`, carried through the converter's leaf map, against the
    port's own init on the meta device."""
    cfg_j, cfg = jax_get_config(arch), get_config(arch)
    shapes_j = jax.eval_shape(partial(jax_api.init_params, cfg=cfg_j), jax.random.PRNGKey(0))
    carried = jax_leaf_map(cfg, shapes_j,
                           row=lambda s, g: jax.ShapeDtypeStruct(s.shape[1:], s.dtype))
    own = tfm.init_params(None, cfg, device="meta")
    assert _shapes(own) == _shapes(carried)
    n_own = sum(t.numel() for t in tree_leaves(own))
    assert n_own == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes_j))
    if arch == "gemma2-9b":
        assert n_own == cfg.param_count() == 9_241_404_928


def test_converter_refuses_unknown_leaves():
    _, cfg, _, _, tree = model("qwen1.5-0.5b")
    with pytest.raises(ValueError, match="does not carry"):
        from_jax_params(cfg, {**tree, "xlstm": np.zeros(3)}, device="cpu")


# ---------------------------------------------------------------------------
# Layers, encoder, full forward
# ---------------------------------------------------------------------------
def _cross_inputs(cfg, B, rng):
    F_ = cfg.encoder_seq
    k = rng.normal(size=(B, F_, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(F_, dtype=np.int32), (B, F_)).copy()
    return {"k": k, "v": v, "pos": pos}


@pytest.mark.parametrize("arch", ARCHS)
def test_layers_match_jax(arch):
    """Every layer of the reduced model alone, prefill length 12 into a
    fresh cache (whisper's with cross K/V of random frames); output, aux
    loss and cache within 1e-5."""
    cfg_j, cfg, _, params, tree = model(arch)
    layers_np = jax_leaf_map(cfg, tree)["layers"]
    rng = np.random.default_rng(11)
    B, S = 2, 12
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    for i, kind in enumerate(cfg.layer_kinds):
        x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        cj = {"kv": jax_init_kv_cache(cfg_j, kind, B, 32)}
        ct = {"kv": init_kv_cache(cfg, kind, B, 32, torch.float32, "cpu")}
        if cfg.is_encdec:
            ckv = _cross_inputs(cfg, B, rng)
            cj["cross_kv"] = jax.tree.map(jnp.asarray, ckv)
            ct["cross_kv"] = _t(ckv)
        yj, cj, aj = jax_tfm._apply_layer(
            jax.tree.map(jnp.asarray, layers_np[i]), jnp.asarray(x), cfg_j, kind,
            jnp.asarray(pos), cj, impl="pallas", kv_chunk=1024, cross=cfg.is_encdec,
            decode=False, long_window=None)
        yt, ct, at = tfm._apply_layer(params["layers"][i], torch.from_numpy(x), cfg, kind,
                                      torch.from_numpy(pos), ct,
                                      cross_kv=ct.get("cross_kv"))
        _close(yt.numpy(), yj, LAYER_TOL, f"layer {i} ({kind})")
        _close(at.numpy(), aj, LAYER_TOL, f"layer {i} aux")
        for key in ("k", "v"):
            _close(ct["kv"][key].numpy(), cj["kv"][key], LAYER_TOL, f"layer {i} cache {key}")
        for key in ("pos", "idx"):
            np.testing.assert_array_equal(ct["kv"][key].numpy(), np.asarray(cj["kv"][key]))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    """The full forward without a cache (whisper: its training path, which
    encodes the frames itself; llava: with patch embeddings), logits and
    aux loss."""
    cfg_j, cfg, params_j, params, _ = model(arch)
    B, S = 2, 12
    batch = {"tokens": np.random.default_rng(5).integers(0, cfg.vocab_size, size=(B, S)),
             **_extras(cfg, B, 6)}
    lj, _, aj = jax_tfm.forward(params_j, cfg_j, jax.tree.map(jnp.asarray, batch), impl="pallas")
    lt, _, at = tfm.forward(params, cfg, _t(batch))
    _close(lt.numpy(), lj, _logit_tol(lj), "logits")
    _close(at.numpy(), aj, LAYER_TOL, "aux")


def test_whisper_encoder_and_cross_kv_match_jax():
    """The non-causal encoder over the frames (1e-5) and the cross K/V it
    gives every decoder layer."""
    cfg_j, cfg, params_j, params, _ = model("whisper-tiny")
    frames = _extras(cfg, 2, 9)["frames"]
    ej = jax_tfm.encode(params_j, cfg_j, jnp.asarray(frames), impl="pallas")
    et = tfm.encode(params, cfg, torch.from_numpy(frames))
    _close(et.numpy(), ej, LAYER_TOL, "encoder")
    kvj = jax_tfm.build_cross_kv(params_j, cfg_j, ej)["groups"][0]
    kvt = tfm.build_cross_kv(params, cfg, et)
    assert len(kvt) == cfg.num_layers
    for i, c in enumerate(kvt):
        for key in ("k", "v"):
            _close(c[key].numpy(), np.asarray(kvj[key])[i], LAYER_TOL, f"cross {key} {i}")
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(kvj["pos"])[i])
    # the encoder is not causal: the last frame moves the first output
    moved = frames.copy()
    moved[:, -1] = np.random.default_rng(10).normal(size=moved[:, -1].shape)
    et2 = tfm.encode(params, cfg, torch.from_numpy(moved))
    assert float((et2[:, 0] - et[:, 0]).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------
def _attach_jax_cross(params_j, cfg_j, cache, frames):
    """As JAX tests/test_decode.py: encode, then put each layer's cross K/V
    into the decode cache."""
    ckv = jax_tfm.build_cross_kv(params_j, cfg_j,
                                 jax_tfm.encode(params_j, cfg_j, frames, impl="pallas"))
    G, rem = jax_tfm._group_split(cfg_j)
    if G > 0:
        for i in range(len(cfg_j.pattern)):
            cache["groups"][i]["cross_kv"] = ckv["groups"][i]
    for i in range(len(rem)):
        cache["rem"][i]["cross_kv"] = ckv["rem"][i]
    return cache


def _caches(cfg_j, cfg, params_j, params, B, max_len, extras):
    cj = jax_api.init_cache(cfg_j, B, max_len)
    ct = api.init_cache(cfg, B, max_len, device="cpu")
    if "frames" in extras:
        cj = _attach_jax_cross(params_j, cfg_j, cj, jnp.asarray(extras["frames"]))
        tfm.attach_cross_kv(ct, tfm.build_cross_kv(
            params, cfg, tfm.encode(params, cfg, torch.from_numpy(extras["frames"]))))
    return cj, ct


def _prefill_decode(cfg_j, cfg, params_j, params, prompt, extras, n_decode, max_len,
                    long_window=None):
    """Prefill (with the family's extras), then n_decode greedy steps on the
    JAX tokens; asserts every step's logits and returns the JAX tokens."""
    B, S = prompt.shape
    cj, ct = _caches(cfg_j, cfg, params_j, params, B, max_len, extras)
    jpre, jdec = jax_steps(cfg_j, long_window)
    pre = api.make_prefill_step(cfg, long_window=long_window)
    dec = api.make_decode_step(cfg, long_window=long_window)
    batch = {"tokens": prompt, **{k: v for k, v in extras.items() if k != "frames"}}
    lj, cj = jpre(params_j, cj, jax.tree.map(jnp.asarray, batch))
    lt, ct = pre(params, ct, _t(batch))
    # positions continue after the prompt and any prepended patches
    start = S + (extras["patch_embeds"].shape[1] if "patch_embeds" in extras else 0)
    toks = []
    for i in range(n_decode + 1):
        lj = np.asarray(lj)
        _close(lt.numpy(), lj, _logit_tol(lj), f"step {i}")
        toks.append(np.argmax(lj, -1))
        if i == n_decode:
            break
        tok = toks[-1][:, None]
        pos = np.full((B, 1), start + i, np.int32)
        lj, cj = jdec(params_j, cj, jnp.asarray(tok, jnp.int32), jnp.asarray(pos))
        lt, ct = dec(params, ct, torch.from_numpy(tok), torch.from_numpy(pos))
    return np.stack(toks, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    """Prefill of 20 tokens (llava with 16 patch embeddings before them,
    whisper with the cross K/V of 64 encoded frames attached), then 4
    decode steps, two rows."""
    cfg_j, cfg, params_j, params, _ = model(arch)
    prompt = np.random.default_rng(20).integers(0, cfg.vocab_size, size=(2, 20))
    _prefill_decode(cfg_j, cfg, params_j, params, prompt, _extras(cfg, 2, 21), 4, 48)


@pytest.mark.parametrize("window", [None, 16])
def test_gemma2_ring_wrap_matches_jax(window):
    """JAX tests/test_decode.py::test_ring_buffer_wraparound in both
    packages: a 40-slot cache, 8 tokens of prefill and 32 decode steps; at
    window 16 the local ring wraps twice. Every step's logits against the
    JAX package, and the last against the port's own full forward."""
    cfg_j, cfg = jax_get_config("gemma2-9b").reduced(), get_config("gemma2-9b").reduced()
    if window is not None:
        cfg_j = dataclasses.replace(cfg_j, sliding_window=window)
        cfg = dataclasses.replace(cfg, sliding_window=window)
    cfg_j, cfg, params_j, params, _ = model("gemma2-9b", cfg_j, cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(1, 40))
    cj, ct = _caches(cfg_j, cfg, params_j, params, 1, 40, {})
    jpre, jdec = jax_steps(cfg_j)
    pre, dec = api.make_prefill_step(cfg), api.make_decode_step(cfg)
    lj, cj = jpre(params_j, cj, {"tokens": jnp.asarray(toks[:, :8])})
    lt, ct = pre(params, ct, {"tokens": torch.from_numpy(toks[:, :8])})
    for t in range(8, 40):
        _close(lt.numpy(), lj, _logit_tol(np.asarray(lj)), f"position {t}")
        pos = np.full((1, 1), t, np.int32)
        lj, cj = jdec(params_j, cj, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        lt, ct = dec(params, ct, torch.from_numpy(toks[:, t:t + 1]), torch.from_numpy(pos))
    _close(lt.numpy(), lj, _logit_tol(np.asarray(lj)), "last")
    full, _, _ = tfm.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    _close(lt.numpy(), full[:, -1].numpy(), 2e-4, "decode against the full forward")


def test_gemma2_long_window_matches_jax():
    """The long-context variant: global layers take the sliding window. A
    prompt of 80 past the 64-slot window, then 4 decode steps; the variant
    must change the logits (the global layers see less) and match the
    JAX package's."""
    cfg_j, cfg, params_j, params, _ = model("gemma2-9b")
    prompt = np.random.default_rng(80).integers(0, cfg.vocab_size, size=(1, 80))
    lw = cfg.sliding_window
    toks = _prefill_decode(cfg_j, cfg, params_j, params, prompt, {}, 4, 96, long_window=lw)
    plain = api.make_prefill_step(cfg)(params, api.init_cache(cfg, 1, 96, device="cpu"),
                                       {"tokens": torch.from_numpy(prompt)})[0]
    local = api.make_prefill_step(cfg, long_window=lw)(
        params, api.init_cache(cfg, 1, 96, device="cpu"), {"tokens": torch.from_numpy(prompt)})[0]
    assert float((plain - local).abs().max()) > 1e-3
    assert toks.shape == (1, 5)


# ---------------------------------------------------------------------------
# Serving engine
# ---------------------------------------------------------------------------
def _isolated(cfg, params, prompt, n):
    """Greedy tokens, top-2 margins and logit tolerance per step, port side."""
    cache = api.init_cache(cfg, 1, 64, device="cpu")
    prefill, decode = api.make_prefill_step(cfg), api.make_decode_step(cfg)
    logits, cache = prefill(params, cache, {"tokens": torch.as_tensor(prompt)[None]})
    toks, margins, tols = [], [], []
    for i in range(n):
        top2 = torch.topk(logits[0], 2).values
        margins.append(float(top2[0] - top2[1]))
        tols.append(_logit_tol(logits.numpy()))
        toks.append(int(torch.argmax(logits[0])))
        if i + 1 < n:
            pos = torch.tensor([[len(prompt) + i]], dtype=torch.int32)
            logits, cache = decode(params, cache, torch.tensor([[toks[-1]]]), pos)
    return toks, margins, tols


@pytest.mark.parametrize("arch", SERVED)
def test_serve_tokens_match_jax(arch):
    """Three text-only requests through both engines, two slots, so one slot
    is reused. Tokens must equal the port's isolated generation, and the
    JAX engine's at every step whose top-2 margin exceeds the logit
    tolerance; a near-tie is reported and ends that request's comparison."""
    cfg_j, cfg, params_j, params, _ = model(arch)
    rng = np.random.default_rng(3)
    mix = [(7, 5), (12, 4), (5, 6)]
    prompts = [rng.integers(0, cfg.vocab_size, size=p) for p, _ in mix]
    eng_j = JaxServeEngine(cfg_j, params_j, slots=2, max_len=64, impl="pallas")
    eng_t = ServeEngine(cfg, params, slots=2, max_len=64, device="cpu")
    reqs_j = [JaxRequest(i, p, max_new_tokens=n) for i, (p, (_, n)) in enumerate(zip(prompts, mix))]
    reqs_t = [Request(i, p, max_new_tokens=n) for i, (p, (_, n)) in enumerate(zip(prompts, mix))]
    for rj, rt in zip(reqs_j, reqs_t):
        eng_j.submit(rj)
        eng_t.submit(rt)
    assert len(eng_j.run()) == len(eng_t.run()) == len(mix)
    ties = []
    for rj, rt in zip(reqs_j, reqs_t):
        toks, margins, tols = _isolated(cfg, params, rt.prompt, rt.max_new_tokens)
        assert rt.out == toks, rt.rid
        for step, (a, b) in enumerate(zip(rj.out, rt.out)):
            if a != b:
                assert margins[step] <= tols[step], (rt.rid, step, margins[step])
                ties.append(f"request {rt.rid} step {step}: margin {margins[step]:.2e}")
                break
    if ties:
        warnings.warn(f"{arch}: near-ties between the engines: " + "; ".join(ties))
