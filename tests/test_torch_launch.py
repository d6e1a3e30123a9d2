"""The port's launch layer against the JAX package.

- `launch/analysis.py`: model_flops, loop_trip_count, executed_flops (total
  and every breakdown entry) and executed_bytes for the ten architectures x
  four shapes, under moe_mode dense and sorted (and gemma2's long_window),
  equal to the JAX package's bit for bit.
- `launch/specs.py`: the meta specs equal the JAX `jax.eval_shape` leaves in
  shape and dtype, leaf by leaf (parameters and caches through
  `convert.jax_leaf_map`, with the group axis dropped from the stacked
  leaves; the optimizer state; the batch), and `input_specs`' kind and
  `runnable` are the JAX package's.
- `launch/metatrace.py`: `MetaTrace` counts what FlopCounterMode counts and
  gives the outputs an uncached meta trace gives.
- `launch/dryrun.py`: records at full size on the meta device, the step run
  for real on the CPU at a reduced size, and `main()`'s files.
- `models/api.py`: the steps' `impl="torch"` gives the kernel route's
  logits (on the CPU, the kernels' plain versions) within the slice-1
  tolerance, 1e-4 x max(1, max|logit|).
"""
import dataclasses
import json
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import base as jax_base
from repro.launch import analysis as jax_analysis
from repro.launch import specs as jax_specs
from repro.optim import adamw as jax_adamw
from repro.optim import constant_schedule as jax_constant_schedule
from repro_torch import configs
from repro_torch.configs import H100, INPUT_SHAPES, HardwareSpec, get_config, get_shape, list_archs
from repro_torch.configs.base import InputShape
from repro_torch.convert import MLSTM_STATE, SLSTM_STATE, jax_leaf_map
from repro_torch.distributed.sharding import per_device_bytes
from repro_torch.launch import analysis, dryrun, specs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.metatrace import MetaTrace
from repro_torch.models import api
from repro_torch.optim import adamw, constant_schedule
from repro_torch.tree import tree_leaves, tree_map

ARCHS = sorted(list_archs())
SHAPES = list(INPUT_SHAPES)
OPT = adamw(constant_schedule(1e-4))
JAX_OPT = jax_adamw(jax_constant_schedule(1e-4))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_input_shapes_and_hardware():
    assert list(INPUT_SHAPES) == list(JAX_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(JAX_SHAPES[name])
        assert get_shape(name) is shape
    jax_fields = {f.name for f in dataclasses.fields(jax_base.HardwareSpec)}
    assert jax_fields <= {f.name for f in dataclasses.fields(HardwareSpec)}
    assert H100 == HardwareSpec(peak_flops=989e12, peak_flops_fp32=67e12, hbm_bw=3.35e12,
                                hbm_bytes=80e9, ici_bw=450e9)
    # the port states no TPU number
    assert not hasattr(configs, "V5E")
    assert all(getattr(H100, f) != getattr(jax_base.V5E, f) for f in jax_fields)


# ---------------------------------------------------------------------------
# analysis: bitwise
# ---------------------------------------------------------------------------
def _bits(x):
    """Every float of a result as its hex form, so == is bitwise."""
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    return (type(x).__name__, float(x).hex())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_analysis_bitwise(arch, shape):
    jc, pc = jax_get_config(arch), get_config(arch)
    js, ps = JAX_SHAPES[shape], INPUT_SHAPES[shape]
    assert _bits(analysis.model_flops(pc, ps)) == _bits(jax_analysis.model_flops(jc, js))
    assert analysis.loop_trip_count(pc) == jax_analysis.loop_trip_count(jc)
    variants = [{"moe_mode": "dense"}, {"moe_mode": "sorted"}]
    if arch.startswith("gemma2"):
        variants += [{"moe_mode": m, "long_window": jc.sliding_window}
                     for m in ("dense", "sorted")]
    for kw in variants:
        got, want = analysis.executed_flops(pc, ps, **kw), jax_analysis.executed_flops(jc, js, **kw)
        assert set(got["breakdown"]) == set(want["breakdown"])
        assert _bits(got) == _bits(want), kw
        got, want = analysis.executed_bytes(pc, ps, **kw), jax_analysis.executed_bytes(jc, js, **kw)
        assert _bits(got) == _bits(want), kw


# ---------------------------------------------------------------------------
# specs: shape and dtype, leaf by leaf
# ---------------------------------------------------------------------------
def _sig(x):
    if isinstance(x, torch.Tensor):
        assert x.device.type == "meta"
        return f"{tuple(x.shape)} {str(x.dtype).replace('torch.', '')}"
    return f"{tuple(x.shape)} {jax.numpy.dtype(x.dtype).name}"


def _jax_sigs(cfg, tree):
    """The JAX tree in the port's layout, each leaf its signature; a leaf
    stacked over the group axis loses that axis, and an xLSTM decode state
    (a tuple in the JAX package) becomes the port's dict."""
    rows = jax_leaf_map(cfg, tree, row=lambda a, g: _sig(jax.ShapeDtypeStruct(a.shape[1:],
                                                                              a.dtype)))
    rows = tree_map(lambda x: x if isinstance(x, str) else _sig(x), rows)
    for kind, layer in zip(cfg.layer_kinds, rows["layers"]):
        if isinstance(layer.get("cell"), list) and kind in ("mlstm", "slstm"):
            names = MLSTM_STATE if kind == "mlstm" else SLSTM_STATE
            layer["cell"] = dict(zip(names, layer["cell"]))
    return rows


def _port_sigs(tree):
    return tree_map(_sig, tree)


@lru_cache(maxsize=None)
def _jax_params(arch):
    return jax_specs.params_specs(jax_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_optimizer_specs(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    p = specs.params_specs(cfg)
    assert _port_sigs(p) == _jax_sigs(jcfg, _jax_params(arch))
    o = specs.opt_specs(cfg, OPT)
    jo = jax.eval_shape(JAX_OPT.init, _jax_params(arch))
    assert set(o) == set(jo) == {"step", "m", "v"}
    for k in ("m", "v"):
        assert _port_sigs(o[k]) == _jax_sigs(jcfg, jo[k])
        assert all(t.dtype == torch.float32 for t in tree_leaves(o[k]))
    # the step count: a Python int in the port, an int32 scalar in JAX
    assert o["step"] == 0 and jo["step"].shape == () and jo["step"].dtype == np.int32


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ps, js = INPUT_SHAPES[shape], JAX_SHAPES[shape]
    assert specs.runnable(cfg, ps) == jax_specs.runnable(jcfg, js)
    args, kind = specs.input_specs(cfg, ps, OPT)
    jargs, jkind = jax_specs.input_specs(jcfg, js, JAX_OPT)
    assert kind == jkind and len(args) == len(jargs)
    assert _port_sigs(args[0]) == _jax_sigs(jcfg, jargs[0])
    if kind == "train":
        assert _port_sigs(args[1]["m"]) == _jax_sigs(jcfg, jargs[1]["m"])
    else:
        assert _port_sigs(args[1]) == _jax_sigs(jcfg, jargs[1])
    assert _port_sigs(list(args[2:])) == [tree_map(_sig, a) for a in jargs[2:]]


def test_vlm_specs_carveout():
    cfg = get_config("llava-next-mistral-7b")
    (p, c, b), kind = specs.input_specs(cfg, INPUT_SHAPES["prefill_32k"], OPT)
    assert kind == "prefill"
    assert "patch_embeds" in b
    assert tuple(b["patch_embeds"].shape) == (32, 2880, 1024)
    assert tuple(b["tokens"].shape) == (32, 32768 - 2880)


# ---------------------------------------------------------------------------
# MetaTrace against FlopCounterMode and an uncached trace
# ---------------------------------------------------------------------------
SMALL = {"train": InputShape("small_train", 96, 2, "train"),
         "prefill": InputShape("small_prefill", 600, 2, "prefill"),
         "decode": InputShape("small_decode", 1100, 3, "decode")}


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_trace_counts_what_flop_counter_counts(arch):
    """On the reduced config, each kind of step: MetaTrace's FLOPs by op
    equal FlopCounterMode's on an uncached run, its outputs have the
    uncached run's shapes, dtypes and strides, and it answered repeats
    from its cache."""
    cfg = get_config(arch).reduced()
    for kind, shape in SMALL.items():
        step = dryrun.build_step(cfg, shape, OPT, impl="torch")
        args, _ = specs.input_specs(cfg, shape, OPT, dtype=torch.float32)
        with FlopCounterMode(display=False) as fc:
            want = step(*args)
        args, _ = specs.input_specs(cfg, shape, OPT, dtype=torch.float32)
        with MetaTrace() as mt:
            got = step(*args)
        assert {str(k): v for k, v in mt.flops.items()} == \
            {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}, kind
        assert mt.hits > 0
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            if isinstance(a, torch.Tensor):
                assert (a.shape, a.dtype, a.stride()) == (b.shape, b.dtype, b.stride()), kind


def _meta_ops(cfg, kind, seq):
    shape = InputShape("ops", seq, 1, kind)
    args, _ = specs.input_specs(cfg, shape, OPT)
    with MetaTrace() as mt:
        dryrun.build_step(cfg, shape, OPT, impl="torch")(*args)
    return mt.calls


def _loop_delta(arch, kind, s1, s2):
    """(ops, loop steps) that the step's loops add from seq s1 to s2, and
    the q blocks they add (full width, meta)."""
    cfg = get_config(arch)
    ops = _meta_ops(cfg, kind, s2) - _meta_ops(cfg, kind, s1)
    if arch == "qwen1.5-0.5b":         # q chunks x kv chunks, every layer
        n = cfg.num_layers
        q = lambda s: 1 if kind == "decode" else -(-s // dryrun.Q_CHUNK)  # noqa: E731
        steps = q(s2) * -(-s2 // dryrun.KV_CHUNK) - q(s1) * -(-s1 // dryrun.KV_CHUNK)
        return ops, n * steps, n * (q(s2) - q(s1))
    block = "rglru" if arch == "recurrentgemma-9b" else "slstm"
    n = sum(k == block for k in cfg.layer_kinds)   # one step a token, in these layers
    return ops, n * (s2 - s1), 0


SIZES = {"qwen1.5-0.5b": (1024, 2048), "recurrentgemma-9b": (64, 128), "xlstm-1.3b": (32, 64)}


@pytest.mark.parametrize("loop", ["attention", "attention_q", "rglru", "slstm", "moe", "train"])
def test_loop_ops_are_metatrace_counts(loop):
    """dryrun.LOOP_OPS and TRAIN_PASSES, which decide the pairs left
    untraced, are the op counts MetaTrace measures: the ops that traces at
    two sizes differ by (below every local window, so only the loop named
    grows) over the loop steps they differ by (a decode's kv steps alone,
    then a prefill's q blocks), and the train step's loop ops over its
    forward's lying in the measured range."""
    if loop == "moe":                  # an expert of the dense MoE, per layer
        cfg = get_config("olmoe-1b-7b")
        half = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=cfg.moe.num_experts // 2))
        with dryrun._moe_mode("dense"):
            ops = _meta_ops(cfg, "decode", 64) - _meta_ops(half, "decode", 64)
        assert ops == dryrun.LOOP_OPS["moe"] * cfg.num_layers * (cfg.moe.num_experts // 2)
    elif loop == "train":
        ratios = []
        for arch, (s1, s2) in SIZES.items():
            fwd = _loop_delta(arch, "prefill", s1, s2)[0]
            ratios.append(_loop_delta(arch, "train", s1, s2)[0] / fwd)
        assert min(ratios) <= dryrun.TRAIN_PASSES <= max(ratios), ratios
    elif loop == "attention":
        ops, steps, _ = _loop_delta("qwen1.5-0.5b", "decode", 2048, 4096)
        assert ops == dryrun.LOOP_OPS["attention"] * steps
    elif loop == "attention_q":
        ops, steps, q_blocks = _loop_delta("qwen1.5-0.5b", "prefill", *SIZES["qwen1.5-0.5b"])
        assert ops == dryrun.LOOP_OPS["attention"] * steps + dryrun.LOOP_OPS["attention_q"] * q_blocks
    else:
        arch = "recurrentgemma-9b" if loop == "rglru" else "xlstm-1.3b"
        ops, steps, _ = _loop_delta(arch, "prefill", *SIZES[arch])
        assert ops == dryrun.LOOP_OPS[loop] * steps


# ---------------------------------------------------------------------------
# dryrun
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", [("qwen1.5-0.5b", "decode_32k"),
                                        ("recurrentgemma-9b", "long_500k"),
                                        ("xlstm-1.3b", "decode_32k")])
def test_dryrun_records_at_full_size(arch, shape):
    cfg = get_config(arch)
    host, prod = make_host_mesh(), make_production_mesh()
    one, many = dryrun.dryrun_pair(arch, shape, [host, prod], verbose=False)
    ps = INPUT_SHAPES[shape]
    lw = dryrun.long_window_for(cfg, shape)
    flops = analysis.executed_flops(cfg, ps, long_window=lw)
    nbytes = analysis.executed_bytes(cfg, ps, long_window=lw)
    args, kind = specs.input_specs(cfg, ps, OPT)
    total = sum(t.numel() * t.element_size() for t in tree_leaves(args)
                if isinstance(t, torch.Tensor))
    for rec, n in ((one, 1), (many, 256)):
        assert rec["kind"] == kind and rec["chips"] == n and not rec["skipped"]
        assert rec["executed_flops_global"] == flops["total"]
        assert rec["executed_flops_breakdown"] == flops["breakdown"]
        assert rec["executed_bytes_global"] == nbytes["total"]
        assert rec["compute_term_s"] == flops["total"] / (n * H100.peak_flops)
        assert rec["memory_term_s"] == nbytes["total"] / (n * H100.hbm_bw)
        assert rec["model_flops"] == analysis.model_flops(cfg, ps)
        assert rec["trace"].startswith("meta") and rec["flop_counter_global"] > 0
        assert rec["outputs"] == {"logits": [ps.global_batch, cfg.padded_vocab_size]}
    assert one["memory"]["argument_size_in_bytes"] == total
    specs_many = dryrun.build_shardings(cfg, prod, args, kind)
    assert many["memory"]["argument_size_in_bytes"] == per_device_bytes(args, specs_many, prod)
    assert many["memory"]["argument_size_in_bytes"] < total
    assert one["collective_bytes_global"] == 0.0 and one["collective_term_s"] == 0.0
    # the 16x16 collective term: the DTensor trace's bytes by kind (the
    # counts themselves are held to the JAX package in test_torch_collectives.py)
    cbytes = many["collective_bytes_global"]
    assert cbytes > 0 and cbytes == sum(many["collective_by_kind"].values())
    assert set(many["collective_by_kind"]) <= {"all-gather", "all-reduce", "reduce-scatter",
                                               "all-to-all"}
    assert many["collective_term_s"] == dryrun.collective_term(cbytes, 256) == \
        cbytes / (256 * H100.ici_bw)
    assert "DTensor trace" in many["collective_note"] and many["collective_trace_s"] > 0
    for rec in (one, many):
        terms = {k: rec[f"{k}_term_s"] for k in ("compute", "memory", "collective")}
        assert rec["dominant"] == max(terms, key=terms.get)
    assert one["fits_hbm"] == (total <= H100.hbm_bytes)
    assert json.loads(json.dumps(one)) == one


def test_dryrun_sizes_that_do_not_fit():
    """The two pairs whose arguments exceed one card's HBM (bf16)."""
    for arch, shape, gib in (("gemma2-9b", "long_500k", 101.91),
                             ("xlstm-1.3b", "decode_32k", 91.01)):
        args, _ = specs.input_specs(get_config(arch), INPUT_SHAPES[shape], OPT)
        total = sum(t.numel() * t.element_size() for t in tree_leaves(args))
        assert round(total / 2**30, 2) == gib
        assert total > H100.hbm_bytes


def test_dryrun_skips_and_limits():
    host = make_host_mesh()
    rec = dryrun.dryrun_one("qwen1.5-0.5b", "long_500k", mesh=host, verbose=False)
    assert rec["skipped"] and rec["note"] == get_config("qwen1.5-0.5b").long_context_note
    ops, what = dryrun.trace_ops(get_config("xlstm-1.3b"), INPUT_SHAPES["prefill_32k"])
    assert ops > dryrun.TRACE_OP_LIMIT and what.startswith("sLSTM loop over S = 32768 in 6 layers")
    rec = dryrun.dryrun_one("xlstm-1.3b", "prefill_32k", mesh=host, verbose=False)
    assert rec["trace"].startswith("skipped (sLSTM loop") and rec["flop_counter_global"] is None
    ops, what = dryrun.trace_ops(get_config("recurrentgemma-9b"), INPUT_SHAPES["prefill_32k"])
    assert ops <= dryrun.TRACE_OP_LIMIT and what.startswith("RG-LRU loop over S = 32768 in 26")
    assert rec["compute_term_s"] > 0 and rec["memory"]["argument_size_in_bytes"] > 0


@pytest.mark.parametrize("arch,kind", [("qwen1.5-0.5b", "train"), ("recurrentgemma-9b", "prefill"),
                                       ("recurrentgemma-9b", "decode"), ("gemma2-9b", "decode"),
                                       ("xlstm-1.3b", "prefill")])
def test_dryrun_executes_reduced_on_the_cpu(arch, kind, monkeypatch):
    red = get_config(arch).reduced()
    overrides = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)}
    monkeypatch.setitem(INPUT_SHAPES, SMALL[kind].name, SMALL[kind])
    one, many = dryrun.dryrun_pair(arch, SMALL[kind].name, [make_host_mesh(), make_production_mesh()],
                                   cfg_overrides=overrides, execute=True, device="cpu",
                                   verbose=False)
    ex = one["execute"]
    assert "execute" not in many
    assert ex["device"] == "cpu" and ex["runs"] == dryrun.EXECUTE_RUNS
    assert ex["outputs_finite"] and ex["wall_ms"] > 0
    assert ex["argument_bytes"] == ex["predicted_argument_bytes"] == \
        one["memory"]["argument_size_in_bytes"]
    assert ex["peak_bytes"] is None and ex["temp_bytes"] is None
    # the kernels do not launch on the CPU
    assert ex["flash_launches_per_call"] == 0 and ex["scan_launches_per_call"] == 0
    assert (ex["loss"] is not None) == (kind == "train")
    if kind == "train":
        assert np.isfinite(ex["loss"])
    assert ex["roofline_share"] == max(one["compute_term_s"], one["memory_term_s"]) / (
        ex["wall_ms"] / 1e3)


def test_fill_cache_holds_the_latest_positions():
    cfg = get_config("gemma2-9b").reduced()       # local window 64, global cache 100
    cache = api.init_cache(cfg, 2, 100, torch.float32, "cpu")
    dryrun.fill_cache(cache, 99, torch.Generator().manual_seed(0))
    for kind, layer in zip(cfg.layer_kinds, cache["layers"]):
        pos, cap = layer["kv"]["pos"], layer["kv"]["k"].shape[1]
        written = torch.arange(99)
        want = torch.full((cap,), -1, dtype=torch.int32)
        want[written % cap] = written.to(torch.int32)       # later positions overwrite
        assert torch.equal(pos[0], want) and torch.equal(pos[1], want), kind
        assert int(layer["kv"]["idx"][0]) == 99


def test_main_writes_records(tmp_path):
    out = tmp_path / "dry"
    assert dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--out", str(out),
                        "--both-meshes"]) == 0
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "long_500k", "--out", str(out),
                        "--mesh", "1x1"]) == 0
    assert dryrun.main(["--arch", "recurrentgemma-9b", "--shape", "decode_32k", "--out",
                        str(out / "cut"), "--batch", "4"]) == 0
    cut = json.loads((out / "cut" / "dryrun_torch_recurrentgemma-9b_decode_32k_16x16.json")
                     .read_text())
    assert cut["batch"] == 4 and cut["batch_cut_from"] == 128
    names = sorted(p.name for p in out.iterdir() if p.is_file())
    assert names == ["dryrun_torch_qwen1_5-0_5b_long_500k_1x1.json",
                     "dryrun_torch_whisper-tiny_decode_32k_16x16.json",
                     "dryrun_torch_whisper-tiny_decode_32k_2x16x16.json"]
    rec = json.loads((out / names[1]).read_text())
    assert rec["chips"] == 256 and rec["trace"].startswith("meta")
    assert json.loads((out / names[0]).read_text())["skipped"]
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--execute",
                     "--out", str(out)])
    # --optimized: sorted_grouped MoE, and whisper's vocab (51865) padded to 2048s
    for arch in ("olmoe-1b-7b", "whisper-tiny"):
        assert dryrun.main(["--arch", arch, "--shape", "decode_32k", "--out",
                            str(out / "opt"), "--optimized", "--mesh", "1x1"]) == 0
    olmoe = json.loads((out / "opt" / "dryrun_torch_olmoe-1b-7b_decode_32k_1x1.json").read_text())
    assert olmoe["moe_mode"] == "sorted_grouped" and olmoe["tag"] == "optimized"
    assert olmoe["executed_flops_global"] == analysis.executed_flops(
        get_config("olmoe-1b-7b"), INPUT_SHAPES["decode_32k"], moe_mode="sorted_grouped")["total"]
    whisper = json.loads((out / "opt" / "dryrun_torch_whisper-tiny_decode_32k_1x1.json").read_text())
    assert whisper["outputs"] == {"logits": [128, 53248]}


# ---------------------------------------------------------------------------
# impl on the prefill and decode steps
# ---------------------------------------------------------------------------
def _logit_tol(logits):
    return 1e-4 * max(1.0, float(logits.abs().max()))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "qwen1.5-0.5b", "gemma2-9b"])
def test_steps_impl_torch_equals_kernel_route(arch):
    cfg = get_config(arch).reduced()
    params = api.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    rng = np.random.default_rng(3)
    B, S, max_len = 2, 90, 128
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(B, S)))
    logits, caches = {}, {}
    for impl in ("kernel", "torch"):
        cache = api.init_cache(cfg, B, max_len, torch.float32, "cpu")
        logits[impl], caches[impl] = api.make_prefill_step(cfg, impl=impl)(
            params, cache, {"tokens": prompt})
    assert (logits["kernel"] - logits["torch"]).abs().max() < _logit_tol(logits["kernel"])
    tok = torch.argmax(logits["kernel"], -1)[:, None]
    for step in range(3):
        pos = torch.full((B, 1), S + step, dtype=torch.int32)
        for impl in ("kernel", "torch"):
            logits[impl], caches[impl] = api.make_decode_step(cfg, impl=impl)(
                params, caches[impl], tok, pos)
        assert (logits["kernel"] - logits["torch"]).abs().max() < _logit_tol(logits["kernel"])
        tok = torch.argmax(logits["kernel"], -1)[:, None]
