#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU.

Phases, each fatal on failure:
  1. check the device (and turn TF32 off);
  2. build the CUDA kernels from the sources under src/repro_torch/kernels/csrc;
  3. hold each kernel against its plain PyTorch version on the card: flash
     attention in fp32 and bf16 on the test cases, ring-buffer caches with
     fully-masked rows, decode splits with an empty lane, and prefill
     blocks that mix skipped tiles and rows without a valid slot; the
     scan with and without an incoming state;
  4. serve recurrentgemma-9b at full width in bf16 through ServeEngine and
     check, by the launch counters, that the serving path ran the kernels;
  5. check that continuous batching equals isolated generation on the card
     (full width, reduced depth, fp32), and that the reduced model on the
     card gives the logits it gives on the CPU;
  6. time each kernel at the serving shapes beside its bound, its plain
     version and, for attention, PyTorch's scaled_dot_product_attention.

Run from the repository root:  python3 chip_smoke.py
Without a CUDA device it exits non-zero and prints no result. It prints the
card's name and power limit, one {"kernels": [...]} line, and, as its last
line, {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     rglru_scan_ref)
from repro_torch.models import api  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCH = "recurrentgemma-9b"
# H100 SXM peaks (NVIDIA data sheet): HBM rate, bf16 tensor-core rate, and
# the fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
SCAN_SOURCE = "src/repro_torch/kernels/csrc/rglru_scan.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:117"
SCAN_REPLACES = "src/repro/kernels/rglru_scan.py:59"
# The cases of tests/test_kernels.py:
# Sq, Skv, nq, nkv, hd, window, softcap (Pallas block sizes dropped).
ATTN_CASES = [
    (128, 128, 4, 2, 64, None, None),
    (64, 256, 8, 1, 64, None, None),
    (50, 130, 8, 2, 64, 32, 50.0),
    (1, 256, 4, 4, 128, None, 30.0),
    (256, 256, 2, 2, 32, 64, None),
    (33, 65, 6, 3, 64, 16, None),
]
# Serving mix of phase 4: (prompt length, new tokens). 2500 wraps the
# 2048-slot window; 2048 fills it exactly.
SERVE_MIX = [(2500, 16), (2048, 20), (1500, 24), (700, 28), (128, 32), (33, 16)]
# Phase 5 mix: more requests than slots, so slots are reused.
BATCH_MIX = [(2100, 8), (700, 12), (33, 6), (300, 10), (1200, 8)]


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------------
def check_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off (torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False)")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")


# ---------------------------------------------------------------------------
# Phase 2: build
# ---------------------------------------------------------------------------
def build_kernels():
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.relative_to(ROOT)}")
    log = lib.with_suffix(".log").read_text().splitlines()
    kernel = "?"
    for line in log:
        if "Compiling entry function" in line:
            kernel = _kernel_name(line.split("'")[1])
        elif ("registers" in line or "warning" in line.lower()
              or ("spill" in line and " 0 bytes spill stores, 0 bytes spill loads" not in line)):
            name = _kernel_name(line.split("'")[1]) if "'" in line else kernel
            print(f"  ptxas {name}:" + line.split(":", 1)[-1].split(" in the function")[0])


KERNELS = ("flash_fwd_kernel", "flash_decode_kernel", "flash_combine_kernel",
           "flash_prefill_kernel", "mean_v_kernel", "chunk_summary", "chunk_carry", "chunk_scan")


def _kernel_name(mangled):
    """`flash_decode_kernel<bf16, 256>` from a mangled kernel name."""
    base = next((k for k in KERNELS if k in mangled), None)
    if base is None:
        return mangled
    tail, args = mangled.split(base, 1)[1], []
    if tail.startswith("I"):
        t = tail[1:]
        if t.startswith("13__nv_bfloat16"):
            args.append("bf16")
        elif t.startswith("f"):
            args.append("float")
        m = re.match(r"(?:13__nv_bfloat16|f)?Li(\d+)E", t)
        if m:
            args.append(m.group(1))
    return base + (f"<{', '.join(args)}>" if args else "")


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def ring_positions(lengths, cap, device):
    """kv_pos of a ring-buffer cache holding sequences of these lengths
    (slot p % cap holds position p; -1 where nothing was written)."""
    pos = torch.full((len(lengths), cap), -1, dtype=torch.int32)
    for row, n in enumerate(lengths):
        p = torch.arange(max(0, n - cap), n, dtype=torch.int32)
        pos[row, p % cap] = p
    return pos.to(device)


def attn_inputs(gen, B, Sq, Skv, nq, nkv, hd, dtype, device):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    return rnd(B, Sq, nq, hd), rnd(B, Skv, nkv, hd), rnd(B, Skv, nkv, hd)


def slice_attention_inputs(kind, gen, device, dtype=torch.bfloat16):
    """The shapes serving gives the flash kernel: a decode tick of 4 slots
    against the 2048-slot window, and a 2500-token prefill against it (its
    first 452 query rows have no valid slot)."""
    cfg = get_config(ARCH)
    nq, nkv, hd, cap = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.sliding_window
    if kind == "decode":
        lengths = [2600, 2048, 1500, 33]
        q, k, v = attn_inputs(gen, 4, 1, cap, nq, nkv, hd, dtype, device)
        q_pos = torch.tensor(lengths, dtype=torch.int32, device=device)[:, None]
        kv_pos = ring_positions(lengths, cap, device)
    else:
        S = 2500
        q, k, v = attn_inputs(gen, 1, S, cap, nq, nkv, hd, dtype, device)
        q_pos = torch.arange(S, dtype=torch.int32, device=device)[None]
        kv_pos = torch.arange(S - cap, S, dtype=torch.int32, device=device)[None]
    return (q, k, v, q_pos, kv_pos), {"window": cap}


# Root-mean-square limit of |kernel - plain| for flash attention, as a share
# of the plain output's rms, by input type. In bf16 the two versions round
# their outputs apart and the tensor-core path rounds P to bf16, about 3e-3
# of the rms between them; a kv tile skipped, or a softmax sum off by a
# few percent, moves it by more than 1e-2.
FLASH_RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def flash_limit(args, kw, want):
    """Elementwise limit of |kernel - plain|. fp32: 1e-5 x max(1, |plain|).
    bf16, from its rounding (unit 2^-8): each version rounds its output
    (2^-7 x |plain| between them), and the tensor-core path rounds each P
    to bf16 before P.V, which moves an output by at most 2^-8 x
    sum_i p_i |v_i| / l, the same attention taken over |V|; plus 1e-5 for
    the fp32 arithmetic."""
    if args[0].dtype == torch.float32:
        return 1e-5 * want.abs().clamp(min=1.0)
    q, k, v, q_pos, kv_pos = args
    v_abs = flash_attention_ref(q, k, v.float().abs(), q_pos, kv_pos, **kw)
    return 2**-7 * want.abs() + 2**-8 * v_abs + 1e-5


def flash_error(args, kw, device, what):
    """Run the kernel and its plain version on the same inputs, hold the
    difference to flash_limit elementwise and to FLASH_RMS_TOL, and return
    the max absolute error, the worst share of the limit, and the rms
    share."""
    got = ops.flash_attention(*args, **kw)
    sync(device)
    want = flash_attention_ref(*args, **kw).float()
    require(bool(torch.isfinite(got).all()), f"flash attention {what}: non-finite output")
    diff = (got.float() - want).abs()
    worst = float((diff / flash_limit(args, kw, want)).max())
    require(worst <= 1.0, f"flash attention {what}: error {worst:.3f} x the limit "
            f"({_tol_text(got.dtype)})")
    rms = float(diff.square().mean().sqrt() / want.square().mean().sqrt().clamp(min=1e-30))
    require(rms <= FLASH_RMS_TOL[got.dtype], f"flash attention {what}: rms error "
            f"{rms:.3e} of the output's rms > {FLASH_RMS_TOL[got.dtype]}")
    return float(diff.max()), worst, rms


def _tol_text(dtype):
    elementwise = ("1e-5 x max(1, |plain|)" if dtype == torch.float32 else
                   "2^-7 x |plain| + 2^-8 x (attention over |V|) + 1e-5")
    return f"{elementwise}, rms within {FLASH_RMS_TOL[dtype]}"


def attention_cases(gen, device, dtype):
    """The named flash-attention cases of phase 3 in `dtype`: (name, args,
    kwargs). The test cases of tests/test_kernels.py; hd 128 and 256 with a
    ring-buffer cache, ragged Skv and fully-masked rows; decode where Skv is
    not a multiple of the split size, at group sizes 16 and 1, with one lane
    whose cache was never written (kv_pos all -1); and prefills whose query
    blocks mix rows without a valid slot, rows with one, and kv tiles the
    mask empties, at both ends of the window."""
    cases = []
    for Sq, Skv, nq, nkv, hd, win, cap in ATTN_CASES:
        q, k, v = attn_inputs(gen, 2, Sq, Skv, nq, nkv, hd, dtype, device)
        q_pos = torch.arange(Skv - Sq, Skv, dtype=torch.int32, device=device)[None].repeat(2, 1)
        kv_pos = torch.arange(Skv, dtype=torch.int32, device=device)[None].repeat(2, 1)
        cases.append((f"test case {(Sq, Skv, nq, nkv, hd, win, cap)}",
                      (q, k, v, q_pos, kv_pos), {"window": win, "softcap": cap}))
    for hd, Skv in ((256, 256), (128, 200)):
        q, k, v = attn_inputs(gen, 2, 300, Skv, 16, 1, hd, dtype, device)
        q_pos = torch.arange(300, dtype=torch.int32, device=device)[None].repeat(2, 1)
        cases.append((f"masked rows hd {hd} Skv {Skv}",
                      (q, k, v, q_pos, ring_positions([300, 150], Skv, device)),
                      {"window": 128}))
    lengths = [2600, 900, 33, 0]   # the last lane's cache was never written
    for nq, nkv, hd, Skv in ((16, 1, 256, 2000), (4, 4, 128, 130)):
        q, k, v = attn_inputs(gen, 4, 1, Skv, nq, nkv, hd, dtype, device)
        q_pos = torch.tensor(lengths, dtype=torch.int32, device=device)[:, None]
        cases.append((f"decode group {nq // nkv} hd {hd} Skv {Skv} with an empty lane",
                      (q, k, v, q_pos, ring_positions(lengths, Skv, device)), {"window": Skv}))
    for nq, nkv, hd, Skv, window in ((4, 2, 128, 256, 128), (16, 1, 256, 512, 512)):
        q, k, v = attn_inputs(gen, 2, 700, Skv, nq, nkv, hd, dtype, device)
        q_pos = torch.arange(700, dtype=torch.int32, device=device)[None].repeat(2, 1)
        cases.append((f"prefill 700 rows hd {hd} Skv {Skv} window {window}, mixed blocks",
                      (q, k, v, q_pos, ring_positions([700, 400], Skv, device)),
                      {"window": window}))
    return cases


def scan_inputs(shape, gen, device, with_h0):
    la = -torch.randn(shape, generator=gen, device=device).abs()
    b = torch.randn(shape, generator=gen, device=device)
    h0 = (torch.randn((shape[0], shape[2]), generator=gen, device=device)
          if with_h0 else None)
    return la, b, h0


def scan_error(shape, gen, device, with_h0):
    la, b, h0 = scan_inputs(shape, gen, device, with_h0)
    got = ops.rglru_scan(la, b, h0)
    sync(device)
    return float((got - rglru_scan_ref(la, b, h0)).abs().max())


SCAN_SHAPES = ((1, 2500, 4096), (3, 17, 5), (1, 100, 70), (2, 257, 4100), (2, 1, 64))


def check_kernels(device):
    """Every kernel against its plain version; returns the max error at the
    serving shapes, per timed entry."""
    gen = torch.Generator(device=device).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        worst = rms = 0.0
        cases = attention_cases(gen, device, dtype)
        for name, args, kw in cases:
            err, w, r = flash_error(args, kw, device, f"{dtype} {name}")
            worst, rms = max(worst, w), max(rms, r)
            print(f"  flash attention {dtype} {name}: max error {err:.3e}, "
                  f"{w:.3f} x the limit, rms {r:.3e}")
        print(f"flash attention: {len(cases)} cases in {dtype} within {_tol_text(dtype)}: "
              f"worst {worst:.3f} x the limit, rms {rms:.3e}")

    errors = {}
    for kind in ("decode", "prefill"):
        args, kw = slice_attention_inputs(kind, gen, device)
        err, worst, rms = flash_error(args, kw, device, f"{kind} serving shape")
        errors[f"flash_attention.{kind}"] = err
        print(f"flash attention {kind} {tuple(args[0].shape)} x {tuple(args[1].shape)} bf16: "
              f"max error {err:.3e}, {worst:.3f} x the limit ({_tol_text(torch.bfloat16)}), "
              f"rms {rms:.3e}")
    for shape in SCAN_SHAPES:
        for with_h0 in (False, True):
            err = scan_error(shape, gen, device, with_h0)
            require(err < 1e-5, f"rglru scan {shape} h0={with_h0}: max error {err:.3e} >= 1e-5")
            if shape == (1, 2500, 4096) and with_h0:
                errors["rglru_scan.prefill"] = err
            print(f"rglru scan {shape} {'with' if with_h0 else 'without'} h0: "
                  f"max error {err:.3e}")
    return errors


# ---------------------------------------------------------------------------
# Phase 4: serve at full width
# ---------------------------------------------------------------------------
class StepRecorder:
    """A tracer for ServeEngine (the `obs` it takes): times the engine's
    serve/prefill and serve/decode spans with the device synchronized at
    both edges, splits the kernels' launch counts by span, and counts the
    non-finite values of the logits each span hands over in `sync`."""

    def __init__(self, device):
        self.device = device
        self.ms = {"prefill": [], "decode": []}
        self.launches = {f"{name}.{kind}": 0 for name in ("flash_attention", "rglru_scan")
                         for kind in ("prefill", "decode")}
        self.nonfinite = 0

    def span(self, name, key=None, **tags):
        return _StepSpan(self, name.rsplit("/", 1)[-1])

    def count(self, name, value=1, **tags):
        pass


class _StepSpan:
    def __init__(self, rec, kind):
        self.rec, self.kind, self.sync = rec, kind, None

    def __enter__(self):
        sync(self.rec.device)
        self.counts = (ops.flash_attention.launches, ops.rglru_scan.launches)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        sync(self.rec.device)
        rec = self.rec
        rec.ms[self.kind].append(1e3 * (time.perf_counter() - self.t0))
        for name, c0 in zip(("flash_attention", "rglru_scan"), self.counts):
            rec.launches[f"{name}.{self.kind}"] += getattr(ops, name).launches - c0
        if exc_type is None:
            require(self.sync is not None, f"serve/{self.kind} span handed over no logits")
            rec.nonfinite += int((~torch.isfinite(self.sync)).sum())
        return False


def make_engine(cfg, dtype, device, slots, max_len, obs=None, seed=0):
    """ServeEngine over random weights from `seed`; returns (engine, seconds
    the weights took)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    params = api.init_params(gen, cfg, dtype, device)
    sync(device)
    init_s = time.perf_counter() - t0
    return ServeEngine(cfg, params, slots=slots, max_len=max_len, dtype=dtype, obs=obs,
                       device=device), init_s


def make_requests(cfg, mix, seed=0):
    """One request per (prompt length, new tokens), prompts from `seed`."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, size=p), max_new_tokens=n)
            for i, (p, n) in enumerate(mix)]


def serve(cfg, dtype, device, mix, slots, max_len):
    """Serve `mix` through ServeEngine with a StepRecorder; returns the
    run's record and the parameters."""
    steps = StepRecorder(device)
    eng, init_s = make_engine(cfg, dtype, device, slots, max_len, obs=steps)
    reqs = make_requests(cfg, mix)
    for r in reqs:
        eng.submit(r)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ops.flash_attention.launches = 0
    ops.rglru_scan.launches = 0
    t0 = time.perf_counter()
    done = eng.run(max_ticks=10_000)
    sync(device)
    rec = {"run_s": time.perf_counter() - t0, "init_s": init_s,
           "flash_launches": ops.flash_attention.launches,
           "scan_launches": ops.rglru_scan.launches,
           "prefill_ms": steps.ms["prefill"], "decode_ms": steps.ms["decode"],
           "launches": steps.launches, "nonfinite": steps.nonfinite}
    rec["max_memory_bytes"] = (torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None)
    rec["tokens"] = sum(len(r.out) for r in reqs)

    require(len(done) == len(reqs), f"{len(done)} of {len(reqs)} requests finished")
    for r in reqs:
        require(r.done and not r.evicted and len(r.out) == r.max_new_tokens,
                f"request {r.rid}: done={r.done} evicted={r.evicted} tokens={len(r.out)}")
    require(rec["nonfinite"] == 0, f"{rec['nonfinite']} non-finite logits")
    kinds = cfg.layer_kinds
    n_attn = sum(k in ("local", "global") for k in kinds)
    n_rec = sum(k == "rglru" for k in kinds)
    n_pre, n_tick = len(rec["prefill_ms"]), len(rec["decode_ms"])
    want = {"flash_attention.prefill": n_attn * n_pre, "flash_attention.decode": n_attn * n_tick,
            "rglru_scan.prefill": n_rec * n_pre, "rglru_scan.decode": 0}
    require(rec["launches"] == want, f"launch counts {rec['launches']} != expected {want}")
    require(rec["flash_launches"] == want["flash_attention.prefill"] + want["flash_attention.decode"]
            and rec["scan_launches"] == want["rglru_scan.prefill"],
            "launches outside the engine's prefill and decode steps")
    return rec, eng.params


def serve_full_width(device):
    cfg = get_config(ARCH)
    rec, params = serve(cfg, torch.bfloat16, device, SERVE_MIX, slots=4, max_len=4096)
    n_params = sum(t.numel() for t in _leaves(params))
    # ModelConfig.param_count() counts 3 * lru_width vector parameters per
    # recurrent block; the block (here and in the JAX package) holds 2: lam
    # and the conv bias.
    n_rec = cfg.layer_kinds.count("rglru")
    require(n_params == cfg.param_count() - n_rec * cfg.lru_width,
            f"{n_params} parameters; ModelConfig.param_count() = {cfg.param_count()}")
    del params
    dec = rec["decode_ms"]
    print(f"serve {ARCH} full width bf16: {n_params:,} parameters "
          f"(ModelConfig.param_count() {cfg.param_count():,}), init {rec['init_s']:.1f} s")
    print("  prefill ms per request (prompt length): " + ", ".join(
        f"{ms:.1f} ({p})" for ms, (p, _) in zip(rec["prefill_ms"], SERVE_MIX)))
    print(f"  decode ticks {len(dec)}: median {statistics.median(dec):.2f} ms, "
          f"mean {statistics.fmean(dec):.2f} ms, max {max(dec):.2f} ms")
    print(f"  {rec['tokens']} tokens in {rec['run_s']:.2f} s: {rec['tokens'] / rec['run_s']:.1f} tokens/s; "
          f"max memory allocated {rec['max_memory_bytes'] / 2**30:.2f} GiB")
    print(f"  launches: flash {rec['flash_launches']} "
          f"({rec['launches']['flash_attention.prefill']} in prefill, "
          f"{rec['launches']['flash_attention.decode']} in decode), "
          f"scan {rec['scan_launches']}")
    return rec


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Phase 5: continuous batching equals isolated generation
# ---------------------------------------------------------------------------
def isolated(cfg, params, prompt, n, max_len, device):
    """Greedy tokens with the top-2 logit margin and max |logit| per step."""
    cache = api.init_cache(cfg, 1, max_len, torch.float32, device)
    prefill, decode = api.make_prefill_step(cfg), api.make_decode_step(cfg)
    toks = torch.as_tensor(prompt, dtype=torch.long, device=device)[None]
    logits, cache = prefill(params, cache, {"tokens": toks})
    out = []
    for i in range(n):
        top2 = torch.topk(logits[0], 2).values
        out.append((int(torch.argmax(logits[0])), float(top2[0] - top2[1]),
                    float(logits.abs().max())))
        if i + 1 < n:
            pos = torch.tensor([[len(prompt) + i]], dtype=torch.int32, device=device)
            logits, cache = decode(params, cache, torch.tensor([[out[-1][0]]], device=device), pos)
    return out


def batching_equals_isolated(cfg, device, mix=BATCH_MIX, slots=4, max_len=4096):
    """Tokens of the batched engine equal isolated generation wherever the
    top-2 margin exceeds 1e-3 x max|logit| (batched and single-row matrix
    products may round differently); a near-tie ends that request's check."""
    eng, _ = make_engine(cfg, torch.float32, device, slots, max_len, seed=1)
    params = eng.params
    reqs = make_requests(cfg, mix, seed=1)
    for r in reqs:
        eng.submit(r)
    require(len(eng.run(max_ticks=10_000)) == len(reqs), "batched run left requests")
    ties = 0
    for r in reqs:
        for step, (tok, (ref, margin, scale)) in enumerate(
                zip(r.out, isolated(cfg, params, r.prompt, r.max_new_tokens, max_len, device))):
            if tok != ref:
                require(margin <= 1e-3 * max(1.0, scale),
                        f"request {r.rid} step {step}: batched {tok} != isolated {ref}, "
                        f"margin {margin:.3e}")
                ties += 1
                break
    print(f"continuous batching == isolated: {len(reqs)} requests, {cfg.num_layers} layers "
          f"at full width fp32, {ties} near-ties")


def card_matches_cpu(device):
    """The reduced model (2 layers, d_model 256, window 64) on the card,
    through the kernels, against the same weights on the CPU, through the
    plain versions that tests/test_torch_serve.py holds to the JAX package:
    prefill and decode logits in fp32 within 1e-4 x max(1, max|logit|). The
    70-token prompt wraps the window."""
    cfg = get_config(ARCH).reduced()
    cpu = torch.device("cpu")
    prompt_len, steps = 70, 4
    params = {cpu: api.init_params(torch.Generator().manual_seed(3), cfg, device=cpu)}
    params[device] = _to(params[cpu], device)
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, size=(1, prompt_len)))
    prefill, decode = api.make_prefill_step(cfg), api.make_decode_step(cfg)
    caches = {d: api.init_cache(cfg, 1, 96, torch.float32, d) for d in (cpu, device)}
    logits = {d: prefill(params[d], caches[d], {"tokens": prompt.to(d)})[0] for d in (cpu, device)}
    worst = 0.0
    for i in range(steps + 1):
        want = logits[cpu]
        err = float((logits[device].cpu() - want).abs().max())
        worst = max(worst, err / max(1.0, float(want.abs().max())))
        if i == steps:
            break
        tok = torch.argmax(want, -1)[:, None]
        pos = torch.tensor([[prompt_len + i]], dtype=torch.int32)
        logits = {d: decode(params[d], caches[d], tok.to(d), pos.to(d))[0] for d in (cpu, device)}
    require(worst <= 1e-4, f"card against CPU: logit error {worst:.3e} x max(1, max|logit|)")
    print(f"card == CPU on the reduced model: prefill + {steps} decode steps, "
          f"logit error {worst:.3e} x max(1, max|logit|)")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# Phase 6: timing
# ---------------------------------------------------------------------------
def time_ms(fn, device, runs=20, warmup=3):
    """Median of `runs` CUDA-event timings of the device's work; L2 is
    flushed before each run, as a layer finds it after the previous layer's
    weights went through. A device-side wait of about half a millisecond
    before the start event lets the host enqueue all of `fn` first, so the
    time does not include the host's enqueue."""
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_bound(q, k, q_pos, kv_pos, window):
    """Least time for this call's work on an H100: each needed input byte
    read once and the output written once, against the operations that
    the mask leaves (4*hd per valid (query, key, head), 2*hd per slot for a
    row with no valid slot, which averages V)."""
    B, Sq, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    rel = q_pos[:, :, None] - kv_pos[:, None, :]
    valid = (kv_pos[:, None, :] >= 0) & (rel >= 0) & (rel < window)
    empty_rows = ~valid.any(-1)                                    # [B, Sq]
    ops_ = nq * hd * (4 * int(valid.sum()) + 2 * Skv * int(empty_rows.sum()))
    slots_read = int((valid.any(1) | empty_rows.any(1, keepdim=True)).sum())
    elt = q.element_size()
    bytes_ = (2 * q.numel() * elt + 2 * slots_read * nkv * hd * elt
              + 4 * (q_pos.numel() + kv_pos.numel()))
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = ops_ / PEAK_OPS_PER_S[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_call(q, k, v, q_pos, kv_pos, window):
    """One scaled_dot_product_attention call on the same inputs and mask
    (layout and mask prepared outside the timed call)."""
    nq, nkv = q.shape[2], k.shape[2]
    qh = q.transpose(1, 2).contiguous()
    kh = k.transpose(1, 2).repeat_interleave(nq // nkv, dim=1).contiguous()
    vh = v.transpose(1, 2).repeat_interleave(nq // nkv, dim=1).contiguous()
    rel = q_pos[:, :, None] - kv_pos[:, None, :]
    mask = ((kv_pos[:, None, :] >= 0) & (rel >= 0) & (rel < window))[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)


def time_kernels(device, errors, launches):
    gen = torch.Generator(device=device).manual_seed(2)
    entries = []
    for kind in ("decode", "prefill"):
        (q, k, v, q_pos, kv_pos), kw = slice_attention_inputs(kind, gen, device)
        bound, by = flash_bound(q, k, q_pos, kv_pos, kw["window"])
        ms = time_ms(lambda: ops.flash_attention(q, k, v, q_pos, kv_pos, **kw), device)
        plain = time_ms(lambda: flash_attention_ref(q, k, v, q_pos, kv_pos, **kw), device)
        lib = time_ms(sdpa_call(q, k, v, q_pos, kv_pos, kw["window"]), device)
        entries.append({"name": f"flash_attention.{kind}", "route": "cuda",
                        "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
                        "launches": launches[f"flash_attention.{kind}"],
                        "max_abs_err": errors[f"flash_attention.{kind}"],
                        "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                        "library_ms": lib,
                        "shape": f"q {list(q.shape)} kv {list(k.shape)} bf16"})
    # the serving path passes the incoming state h0
    shape = (1, 2500, 4096)
    la, b, h0 = scan_inputs(shape, gen, device, with_h0=True)
    t_bytes = (3 * la.numel() + h0.numel()) * 4 / HBM_BYTES_PER_S
    t_ops = 3 * la.numel() / PEAK_OPS_PER_S[torch.float32]
    entries.append({"name": "rglru_scan.prefill", "route": "cuda", "source": SCAN_SOURCE,
                    "replaces": SCAN_REPLACES, "launches": launches["rglru_scan.prefill"],
                    "max_abs_err": errors["rglru_scan.prefill"],
                    "ms": time_ms(lambda: ops.rglru_scan(la, b, h0), device),
                    "plain_ms": time_ms(lambda: rglru_scan_ref(la, b, h0), device),
                    "bound_ms": 1e3 * max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": None, "shape": f"{list(shape)} fp32 with h0"})
    for e in entries:
        print(f"{e['name']}: {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
              f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}), library "
              f"{'-' if e['library_ms'] is None else format(e['library_ms'], '.4f')} ms")
    return entries


def main():
    check_device()
    device = torch.device("cuda", torch.cuda.current_device())
    build_kernels()
    errors = check_kernels(device)
    rec = serve_full_width(device)
    torch.cuda.empty_cache()
    batching_equals_isolated(dataclasses.replace(get_config(ARCH), num_layers=3), device)
    card_matches_cpu(device)
    torch.cuda.empty_cache()
    entries = time_kernels(device, errors, rec["launches"])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
