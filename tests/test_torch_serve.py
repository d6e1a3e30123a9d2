"""The port's recurrentgemma-9b serving slice against the JAX package.

Weights made by the JAX package are carried over with
`repro_torch.convert.from_jax_params`; inputs are made with numpy from
fixed seeds. The JAX side runs `impl="pallas"` (interpret mode on the CPU),
the port runs on the CPU, where its kernel wrappers take their plain
versions. The model is `get_config("recurrentgemma-9b").reduced()`: 2 layers
(rglru, local), d_model 256, window 64.
"""
import ast
import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import api as jax_api
from repro.models.attention import attention as jax_attention
from repro.models.attention import init_kv_cache as jax_init_kv_cache
from repro.models.rglru import rglru_block as jax_rglru_block
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import build
from repro_torch.models import api
from repro_torch.models.attention import attention, init_kv_cache
from repro_torch.models.rglru import rglru_block
from repro_torch.serve import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-9b"
LAYER_TOL = 1e-5


def _logit_tol(logits):
    return 1e-4 * max(1.0, float(np.abs(logits).max()))


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    params_j = jax_api.init_params(jax.random.PRNGKey(0), cfg_j)
    params = from_jax_params(cfg, jax.tree.map(np.asarray, params_j), device="cpu")
    steps = {"prefill": jax.jit(jax_api.make_prefill_step(cfg_j, impl="pallas")),
             "decode": jax.jit(jax_api.make_decode_step(cfg_j, impl="pallas"))}
    return cfg_j, cfg, params_j, params, steps


@pytest.fixture(scope="module")
def port_model():
    cfg = get_config(ARCH).reduced()
    return cfg, api.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")


def test_config_matches_jax():
    for reduce in (False, True):
        cj, ct = jax_get_config(ARCH), get_config(ARCH)
        if reduce:
            cj, ct = cj.reduced(), ct.reduced()
        port_fields = dataclasses.asdict(ct)
        jax_fields = {k: v for k, v in dataclasses.asdict(cj).items() if k in port_fields}
        assert port_fields == jax_fields
        assert ct.layer_kinds == cj.layer_kinds
        assert ct.padded_vocab_size == cj.padded_vocab_size
        assert ct.param_count() == cj.param_count()
    assert get_config(ARCH).param_count() == 9_396_301_824


def _count(tree):
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count(v) for v in tree)
    return int(np.prod(tree.shape))


def test_init_params_shapes_match_jax(model, port_model):
    """The port's own init has the JAX init's leaves and shapes (its random
    numbers differ). Both hold lru_width fewer parameters per recurrent
    block than ModelConfig.param_count(), which counts 3 * lru_width vector
    parameters where the block has 2 (lam and the conv bias)."""
    _, cfg, params_j, converted, _ = model
    _, own = port_model
    shapes = jax.tree.map(lambda t: tuple(t.shape), converted)
    assert jax.tree.map(lambda t: tuple(t.shape), own) == shapes
    n_rec = cfg.layer_kinds.count("rglru")
    assert _count(own) == _count(params_j) == cfg.param_count() - n_rec * cfg.lru_width


def test_converted_layer_order_matches_jax(model):
    """A 5-layer tree of pattern (rglru, local) — two stacked groups and one
    remainder layer, leaves drawn at random in the JAX layout. The JAX
    package runs group g, position i as layer 2 g + i and the remainder
    after; from_jax_params must put each leaf there, untransposed."""
    _, _, params_j, _, _ = model
    base = jax.tree.map(np.asarray, params_j)
    rng = np.random.default_rng(3)

    def draw(shape):
        return rng.normal(size=shape).astype(np.float32)

    tree = {"embed": base["embed"], "final_norm": base["final_norm"],
            "groups": [jax.tree.map(lambda a: draw((2,) + a.shape[1:]), grp)
                       for grp in base["groups"]],
            "rem": [jax.tree.map(lambda a: draw(a.shape[1:]), base["groups"][0])]}
    params = from_jax_params(get_config(ARCH).reduced(num_layers=5), tree, device="cpu")
    expected = [jax.tree.map(lambda a, g=g: a[g], tree["groups"][i])
                for g in range(2) for i in range(2)] + tree["rem"]
    assert len(params["layers"]) == len(expected) == 5
    for got, want in zip(params["layers"], expected):
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (_, g), (_, w) in zip(flat_got, flat_want):
            np.testing.assert_array_equal(g.numpy(), w)


def _layer(params_j, i):
    """Layer i of the reduced model (one pattern group, no remainder)."""
    return jax.tree.map(lambda a: a[0], params_j["groups"][i])


@pytest.mark.parametrize("S", [1, 12])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_matches_jax(model, S, with_state):
    cfg_j, cfg, params_j, params, _ = model
    rng = np.random.default_rng(S + 10 * with_state)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = {"h": rng.normal(size=(2, cfg.lru_width)).astype(np.float32),
                 "conv": rng.normal(size=(2, cfg.conv_kernel - 1, cfg.lru_width)).astype(np.float32)}
    yj, sj = jax_rglru_block(_layer(params_j, 0)["rec"], jnp.asarray(x), cfg_j,
                             state=None if state is None else jax.tree.map(jnp.asarray, state),
                             impl="pallas")
    yt, st = rglru_block(params["layers"][0]["rec"], torch.from_numpy(x), cfg,
                         state=None if state is None else {k: torch.from_numpy(v) for k, v in state.items()})
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < LAYER_TOL
    assert (st is None) == (sj is None)
    if with_state:
        for key in ("h", "conv"):
            assert np.abs(st[key].numpy() - np.asarray(sj[key])).max() < LAYER_TOL


@pytest.mark.parametrize("S", [70])
def test_rglru_prefill_with_state_matches_jax(model, S):
    """Prefill from a nonzero incoming state: the port passes the state to
    the scan as its initial state, the reference scans from zero and folds
    the state in with exp(cumsum(log_a)). The two sum log_a in different
    orders, so outputs and the new state agree within 1e-5 x max(1, |ref|)."""
    cfg_j, cfg, params_j, params, _ = model
    rng = np.random.default_rng(100 + S)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    state = {"h": (4.0 * rng.normal(size=(2, cfg.lru_width))).astype(np.float32),
             "conv": rng.normal(size=(2, cfg.conv_kernel - 1, cfg.lru_width)).astype(np.float32)}
    yj, sj = jax_rglru_block(_layer(params_j, 0)["rec"], jnp.asarray(x), cfg_j,
                             state=jax.tree.map(jnp.asarray, state), impl="pallas")
    yt, st = rglru_block(params["layers"][0]["rec"], torch.from_numpy(x), cfg,
                         state={k: torch.from_numpy(v) for k, v in state.items()})
    for got, want in ((yt, yj), (st["h"], sj["h"]), (st["conv"], sj["conv"])):
        want = np.asarray(want)
        assert np.all(np.abs(got.numpy() - want) <= 1e-5 * np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("S", [20, 70])
def test_attention_cache_writes_match_jax(model, S):
    """Prefill (S < cap, and S >= cap where the ring buffer keeps the last cap
    tokens), then one decode write, against the JAX layer."""
    cfg_j, cfg, params_j, params, _ = model
    pj, pt = _layer(params_j, 1)["attn"], params["layers"][1]["attn"]
    rng = np.random.default_rng(S)
    B, max_len = 2, 96
    cj = jax_init_kv_cache(cfg_j, "local", B, max_len)
    ct = init_kv_cache(cfg, "local", B, max_len, torch.float32, "cpu")
    for pos in (np.arange(S, dtype=np.int32)[None].repeat(B, 0),
                np.full((B, 1), S, np.int32)):
        x = rng.normal(size=(B, pos.shape[1], cfg.d_model)).astype(np.float32)
        yj, cj = jax_attention(pj, jnp.asarray(x), cfg_j, "local", jnp.asarray(pos),
                               cache=cj, impl="pallas")
        yt, ct = attention(pt, torch.from_numpy(x), cfg, "local",
                           torch.from_numpy(pos), cache=ct)
        assert np.abs(yt.numpy() - np.asarray(yj)).max() < LAYER_TOL
        for key in ("k", "v"):
            assert np.abs(ct[key].numpy() - np.asarray(cj[key])).max() < LAYER_TOL
        for key in ("pos", "idx"):
            np.testing.assert_array_equal(ct[key].numpy(), np.asarray(cj[key]))


def test_prefill_past_the_window_attends_the_ring_only(model):
    """A prompt longer than the local window (S = 160 against 64 slots):
    both packages write the ring first and attend over it, so a row at
    position p sees only the cached positions S-64..p. Rows p < S-64 see
    no slot and return the mean of the cached V; every other row but the
    last misses the part of its window before S-64; the last row alone
    equals windowed attention over the whole prompt. The port keeps this
    (ROADMAP Queue 3, reference defect 14) and equals the JAX layer."""
    cfg_j, cfg, params_j, params, _ = model
    pj, pt = _layer(params_j, 1)["attn"], params["layers"][1]["attn"]
    B, S, cap = 2, 160, cfg.sliding_window
    rng = np.random.default_rng(160)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    cj = jax_init_kv_cache(cfg_j, "local", B, 192)
    ct = init_kv_cache(cfg, "local", B, 192, torch.float32, "cpu")
    assert ct["k"].shape[1] == cap == 64
    yj, _ = jax_attention(pj, jnp.asarray(x), cfg_j, "local", jnp.asarray(pos),
                          cache=cj, impl="pallas")
    yt, ct = attention(pt, torch.from_numpy(x), cfg, "local", torch.from_numpy(pos), cache=ct)
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < LAYER_TOL
    free, _ = attention(pt, torch.from_numpy(x), cfg, "local", torch.from_numpy(pos))
    g = cfg.num_heads // cfg.num_kv_heads
    mean_v = ct["v"].mean(1).repeat_interleave(g, dim=1).reshape(B, -1) @ pt["wo"]
    empty = S - cap
    assert (yt[:, :empty] - mean_v[:, None]).abs().max() < LAYER_TOL
    assert (yt[:, -1] - free[:, -1]).abs().max() < LAYER_TOL
    short = (yt[:, empty:-1] - free[:, empty:-1]).abs().amax(dim=(0, 2))
    assert bool((short > 1e-3).all())


@pytest.mark.parametrize("S", [20, 64, 70])
def test_prefill_and_decode_logits_match_jax(model, S):
    """Prefill logits, then every decode step's logits. At S = 70 the prompt
    wraps the 64-slot window and the decode writes over a key still in the
    window, exactly as the reference does."""
    cfg_j, cfg, params_j, params, steps = model
    prompt = np.random.default_rng(S).integers(0, cfg.vocab_size, size=(1, S))
    cj = jax_api.init_cache(cfg_j, 1, 96)
    ct = api.init_cache(cfg, 1, 96, device="cpu")
    prefill, decode = api.make_prefill_step(cfg), api.make_decode_step(cfg)
    lj, cj = steps["prefill"](params_j, cj, {"tokens": jnp.asarray(prompt, jnp.int32)})
    lt, ct = prefill(params, ct, {"tokens": torch.from_numpy(prompt)})
    tok = int(np.argmax(np.asarray(lj)[0]))
    for i in range(6):
        assert np.abs(lt.numpy() - np.asarray(lj)).max() < _logit_tol(np.asarray(lj)), i
        pos = np.array([[S + i]], np.int32)
        lj, cj = steps["decode"](params_j, cj, jnp.asarray([[tok]], jnp.int32), jnp.asarray(pos))
        lt, ct = decode(params, ct, torch.tensor([[tok]]), torch.from_numpy(pos))
        tok = int(np.argmax(np.asarray(lj)[0]))
    assert np.abs(lt.numpy() - np.asarray(lj)).max() < _logit_tol(np.asarray(lj))


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


def test_serve_tokens_match_jax(model):
    """The heterogeneous request mix of tests/test_serve.py through both
    engines. Tokens must agree at every step whose top-2 margin exceeds the
    logit tolerance; a near-tie is reported, and ends the comparison of that
    request because the histories part there."""
    cfg_j, cfg, params_j, params, _ = model
    rng = np.random.default_rng(0)
    mix = [(6, 5), (11, 8), (4, 3), (9, 6), (7, 4)]
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
        warnings.warn("near-ties between the engines: " + "; ".join(ties))


# ---------------------------------------------------------------------------
# Engine contracts inside the port (tests/test_serve.py, ported)
# ---------------------------------------------------------------------------
def _reference(cfg, params, prompt, n):
    out = api.greedy_generate(cfg, params, torch.as_tensor(prompt)[None], steps=n,
                              max_len=64, device="cpu")
    return [int(t) for t in out[0]]


def test_single_request_matches_reference(port_model):
    cfg, params = port_model
    eng = ServeEngine(cfg, params, slots=2, max_len=64, device="cpu")
    prompt = np.arange(5, 13) % cfg.vocab_size
    eng.submit(Request(0, prompt, max_new_tokens=6))
    done = eng.run()
    assert len(done) == 1 and done[0].done
    assert done[0].out == _reference(cfg, params, prompt, 6)


def test_continuous_batching_heterogeneous(port_model):
    cfg, params = port_model
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=p), max_new_tokens=n)
            for i, (p, n) in enumerate([(6, 5), (11, 8), (4, 3), (9, 6), (7, 4)])]
    eng = ServeEngine(cfg, params, slots=2, max_len=64, device="cpu")
    for r in reqs:
        eng.submit(r)
    assert len(eng.run()) == len(reqs)
    for r in reqs:
        assert r.out == _reference(cfg, params, r.prompt, r.max_new_tokens), r.rid


def test_slot_reuse(port_model):
    cfg, params = port_model
    eng = ServeEngine(cfg, params, slots=1, max_len=64, device="cpu")
    p1, p2 = np.arange(4), np.arange(10, 16)
    eng.submit(Request(0, p1, max_new_tokens=3))
    eng.submit(Request(1, p2, max_new_tokens=3))
    done = eng.run()
    assert [r.rid for r in done] == [0, 1]
    assert done[1].out == _reference(cfg, params, p2, 3)


def test_max_ticks_eviction_frees_slot(port_model):
    cfg, params = port_model
    eng = ServeEngine(cfg, params, slots=1, max_len=64, deadline_ticks=4, device="cpu")
    stuck = Request(0, np.arange(4), max_new_tokens=1000)
    nxt = Request(1, np.arange(10, 16), max_new_tokens=3)
    eng.submit(stuck)
    eng.submit(nxt)
    done = eng.run(max_ticks=50)
    assert [r.rid for r in done] == [0, 1]
    assert stuck.done and stuck.evicted and len(stuck.out) == 1 + 4
    assert nxt.done and not nxt.evicted
    assert nxt.out == _reference(cfg, params, nxt.prompt, 3)


def test_per_request_deadline_overrides_engine_default(port_model):
    cfg, params = port_model
    eng = ServeEngine(cfg, params, slots=2, max_len=64, deadline_ticks=2, device="cpu")
    a = Request(0, np.arange(4), max_new_tokens=1000, deadline_ticks=5)
    b = Request(1, np.arange(6), max_new_tokens=3)   # completes at its budget
    eng.submit(a)
    eng.submit(b)
    eng.run(max_ticks=50)
    assert a.evicted and len(a.out) == 1 + 5
    assert b.done and not b.evicted and len(b.out) == 3


# ---------------------------------------------------------------------------
# Boundary guards
# ---------------------------------------------------------------------------
def _forbidden(name):
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "profile_serve.py", ROOT / "check_flash_limits.py",
        ROOT / "profile_genfv.py", ROOT / "profile_spans.py", ROOT / "ab_genfv_rounds.py",
        ROOT / "genfv_paper_rounds.py", ROOT / "profile_collectives.py",
        ROOT / "ab_flash.py"] + sorted(
        (ROOT / "examples").glob("torch_*.py"))
    assert len(files) > 10
    names = {str(p.relative_to(ROOT / "src")) for p in files if "src" in p.parts}
    assert {"repro_torch/fl/faults.py", "repro_torch/checkpoint/io.py",
            "repro_torch/obs/trace.py", "repro_torch/obs/sinks.py",
            "repro_torch/obs/metrics.py", "repro_torch/exp/artifacts.py",
            "repro_torch/optim/optimizers.py", "repro_torch/diffusion/unet.py",
            "repro_torch/diffusion/ddpm.py", "repro_torch/gen/sampler.py",
            "repro_torch/gen/service.py", "repro_torch/gen/pretrain.py",
            "repro_torch/gen/calib.py", "repro_torch/models/moe.py",
            "repro_torch/models/transformer.py", "repro_torch/configs/gemma2_9b.py",
            "repro_torch/configs/whisper_tiny.py", "repro_torch/configs/grok_1_314b.py",
            "repro_torch/configs/olmoe_1b_7b.py", "repro_torch/configs/qwen1_5_0_5b.py",
            "repro_torch/configs/gemma_2b.py", "repro_torch/configs/minicpm_2b.py",
            "repro_torch/configs/llava_next_mistral_7b.py",
            "repro_torch/configs/xlstm_1_3b.py", "repro_torch/models/xlstm.py",
            "repro_torch/launch/train.py", "repro_torch/optim/schedules.py"} <= names
    assert {"torch_quickstart.py", "torch_genfv_cifar.py", "torch_diffusion_aigc.py",
            "torch_serve_demo.py", "torch_scenario_sweep.py", "torch_train_backbone.py",
            "torch_federated_lm.py"} <= {p.name for p in files}
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.serve, repro_torch.convert, repro_torch.kernels.ops\n"
        "import repro_torch.fl.faults, repro_torch.fl.rounds, repro_torch.checkpoint\n"
        "import repro_torch.obs, repro_torch.obs.sinks\n"
        "import repro_torch.gen, repro_torch.exp, repro_torch.optim, repro_torch.diffusion\n"
        "import repro_torch.fl.generator, repro_torch.fl.stream, repro_torch.core.convergence\n"
        "import repro_torch.exp.sweep, repro_torch.exp.analysis\n"
        "import repro_torch.models.moe, repro_torch.models.transformer\n"
        "import repro_torch.models.xlstm, repro_torch.launch.train, repro_torch.data\n"
        "from repro_torch.configs import get_config, list_archs\n"
        "[get_config(a) for a in list_archs()]\n"
        "print('imported')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and "imported" in res.stdout, res.stderr


def test_engine_defaults_to_cuda(port_model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    cfg, params = port_model
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        api.init_cache(cfg, 1, 8)


def test_model_api_defaults_to_cuda(port_model):
    """init_params and greedy_generate run on the card unless asked for
    another device, and refuse a generator or parameters that lie elsewhere."""
    cfg, params = port_model
    prompt = torch.arange(4)[None]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            api.init_params(torch.Generator().manual_seed(0), cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            api.greedy_generate(cfg, params, prompt, 2)
    with pytest.raises(ValueError, match="generator lies on cpu"):
        api.init_params(torch.Generator().manual_seed(0), cfg, device="meta")
    with pytest.raises(ValueError, match="parameters lie on cpu"):
        api.greedy_generate(cfg, params, prompt, 2, device="meta")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    assert build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(tmp_path / "out")
    assert not (tmp_path / "out").exists()
