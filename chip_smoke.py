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
  6. run the GenFV round loop (GenFVRunner, fp32): three rounds of the
     paper's ResNet-18 at full width on CIFAR-10's sizes, timed by stage;
     the card's float64 planner against the numpy planner on those fleets;
     the reduced run on the card against the same run on the CPU; and one
     fleet step at two buckets (this path runs no hand-written kernel);
     then the round loop under faults at full width, traced by the port's
     Obs: poisoned updates rejected inside the fleet step (the finite mask
     equal to the injected poison), late updates buffered and merged, a
     forced departure; a poisoned fleet step against the clean fleet
     without that vehicle; the guarded eq. 4 against the unguarded one on
     a clean fleet; a sequential round against the vectorized one;
     golden resume and tracer neutrality bitwise under deterministic cuDNN;
     the reduced faulted run on the card against the CPU; then, with the
     DDPM generator (genfv_ddpm): the reference-pool pretraining twice per
     cuDNN setting, three full-width rounds priced with the card's measured
     t_image, the sampler's bucket and shard invariance and its throughput
     at base widths 16 and 64, a reduced ddpm run against the CPU, and
     golden resume with t_image from the checkpoint; then the streaming
     RSU and the experiment layer (genfv_stream_sweep): a full-width
     StreamEngine run under rush_hour_deep_fade traced by stage, the
     full-quorum stream against train() and a mid-stream resume (bitwise
     under deterministic cuDNN), a churn pair on the card against the CPU,
     a full-width sweep of the five scenarios with its planner dispatches
     re-planned one by one and Theorem 1's table, sweep == per-cell
     (deterministic cuDNN), a fault-free divergence kept on both paths, and
     two pretrainings bitwise under the process's cuDNN flags;
  7. time each kernel at the serving shapes beside its bound, its plain
     version and, for attention, PyTorch's scaled_dot_product_attention.

Run from the repository root:  python3 chip_smoke.py
Without a CUDA device it exits non-zero and prints no result. It prints the
card's name and power limit, one {"kernels": [...]} line, and, as its last
line, {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import GenFVConfig, StreamConfig  # noqa: E402
from repro_torch.core.emd import (add_weighted, aggregate_stacked_guarded,  # noqa: E402
                                  data_weights, emd_many)
from repro_torch.fl import fleet as fleet_mod  # noqa: E402
from repro_torch.core.planner import bucket_size  # noqa: E402
from repro_torch.core.two_scale import plan_round, plan_rounds_batched  # noqa: E402
from repro_torch.diffusion.ddpm import DDPM, make_ddpm  # noqa: E402
from repro_torch.exp import ExperimentSpec, Sweep, theorem1_comparison  # noqa: E402
from repro_torch.exp import sweep as sweep_mod  # noqa: E402
from repro_torch.fl.faults import FaultSpec  # noqa: E402
from repro_torch.fl import rounds as rounds_mod  # noqa: E402
from repro_torch.fl.rounds import GenFVRunner, RunConfig  # noqa: E402
from repro_torch.fl.stream import StreamEngine  # noqa: E402
from repro_torch.gen import service as gen_service  # noqa: E402
from repro_torch.gen.calib import (CALIB_BUCKET, MeasuredService, _calib_key,  # noqa: E402
                                   load_calibration, save_calibration)
from repro_torch.gen.pretrain import deterministic_cudnn, pretrain_ddpm  # noqa: E402
from repro_torch.gen.sampler import image_noise, sample_schedule  # noqa: E402
from repro_torch.gen.service import BatchedDDPMGenerator  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     rglru_scan_ref)
from repro_torch.models import api  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.tree import FlatSpec, tree_leaves, tree_map  # noqa: E402

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
def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def check_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA device")
    print(card())
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
    n_params = sum(t.numel() for t in tree_leaves(params))
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
    params[device] = tree_map(lambda x: x.to(device), params[cpu])
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


# ---------------------------------------------------------------------------
# Phase 6: the GenFV round loop
# ---------------------------------------------------------------------------
# The paper's ResNet-18 (64-128-256-512) on CIFAR-10's sizes, over the
# procedural dataset, otherwise RunConfig()'s defaults.
GENFV_FULL = dict(width_mult=1.0, train_size=50_000, test_size=10_000, rounds=3)
GENFV_REDUCED = dict(rounds=2, train_size=400, test_size=64)
# One round on the card against the same round on the CPU, from the same
# weights. float32 training amplifies rounding along a round's 16 + 4 SGD
# steps (tests/test_torch_genfv_baselines.py measures it), so the card is held to
# the tolerances the CPU tests hold the port to against the JAX package.
GENFV_PARAM_TOL = 2e-2      # max |delta| of the global parameters
GENFV_LOSS_RTOL = 2e-3      # the round's loss, relative
# DESIGN.md's planner contract: alpha bitwise, l/phi/t_bar to 1e-3, b_gen +-1
PLAN_ATOL = 1e-3
# The fleet step's aggregate across buckets on the card. cuDNN's default
# algorithms are not deterministic (the same bucket twice differs too), so
# the aggregate moves by a few 1e-6 between buckets; with
# torch.backends.cudnn.deterministic it is bitwise, at about a quarter more
# fleet-step time (PERF.md).
BUCKET_TOL = 1e-4


class RoundRecorder:
    """A tracer for GenFVRunner (the `obs` it takes, which only opens spans):
    times each span with the device synchronized at both edges."""
    enabled = False

    def __init__(self, device):
        self.device = device
        self.ms = {}

    def span(self, name, key=None, **tags):
        return _RoundSpan(self, name)


class _RoundSpan:
    def __init__(self, rec, name):
        self.rec, self.name, self.sync = rec, name, None

    def __enter__(self):
        sync(self.rec.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        sync(self.rec.device)
        self.rec.ms.setdefault(self.name, []).append(1e3 * (time.perf_counter() - self.t0))
        return False


def _flat(params):
    return FlatSpec(params).flatten(params)


def genfv_full_width(device):
    """Three rounds at full width through begin_round / plan / finish_round,
    each stage timed; returns the runner and a record per round."""
    rec = RoundRecorder(device)
    t0 = time.perf_counter()
    runner = GenFVRunner(RunConfig(**GENFV_FULL), obs=rec, device=device)
    sync(device)
    n_params = _flat(runner.server.params).numel()
    print(f"genfv: ResNet-18 width {runner.run.width_mult}, {n_params:,} parameters, "
          f"cifar10 {GENFV_FULL['train_size']}/{GENFV_FULL['test_size']} images, "
          f"{GENFV_FULL['rounds']} rounds; runner built in {time.perf_counter() - t0:.1f} s")
    cfg = runner.cfg
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ops.flash_attention.launches = 0
    ops.rglru_scan.launches = 0
    rounds = []
    for t in range(GENFV_FULL["rounds"]):
        b_prev = runner.b_prev
        sync(device)
        t0 = time.perf_counter()
        pending = runner.begin_round(t)
        plan = runner.plan(pending)
        log = runner.finish_round(pending, plan)
        sync(device)
        ms = {k: v[-1] for k, v in rec.ms.items()}
        r = {"round": t, "selected": log.selected,
             "bucket": bucket_size(log.selected) if log.selected else 0,
             "b_gen": log.b_gen, "t_bar": log.t_bar, "bcd_iters": log.bcd_iters,
             "loss": log.loss, "accuracy": log.accuracy, "planner_syncs": plan.syncs,
             "plan_ms": ms["round/plan"], "generate_ms": ms["round/generate"],
             "fleet_step_ms": ms["round/aggregate"], "eval_ms": ms["round/eval"],
             "round_ms": 1e3 * (time.perf_counter() - t0)}
        r["fleet_images_per_s"] = (log.selected * cfg.local_steps * cfg.batch_size
                                   / (r["fleet_step_ms"] / 1e3))
        rounds.append((pending, b_prev, plan, r))
        print(f"genfv round {t}: selected {r['selected']}, bucket {r['bucket']}, "
              f"b_gen {r['b_gen']}, t_bar {r['t_bar']:.4f} s, bcd_iters {r['bcd_iters']}, "
              f"loss {r['loss']:.4f}, accuracy {r['accuracy']:.4f}; ms: plan "
              f"{r['plan_ms']:.2f} ({r['planner_syncs']} syncs), generate + omega_a "
              f"{r['generate_ms']:.2f}, fleet step {r['fleet_step_ms']:.2f} "
              f"({r['fleet_images_per_s']:.0f} images/s of local SGD), eval "
              f"{r['eval_ms']:.2f}, round {r['round_ms']:.2f}")
        require(math.isfinite(r["loss"]) and 0.0 <= r["accuracy"] <= 1.0,
                f"genfv round {t}: loss {r['loss']}, accuracy {r['accuracy']}")
    flat = _flat(runner.server.params)
    require(all(x.device == device for x in tree_leaves(runner.server.params)),
            "the runner's parameters left the card")
    require(bool(torch.isfinite(flat).all()), "non-finite global parameters")
    require(ops.flash_attention.launches == 0 and ops.rglru_scan.launches == 0,
            "the GenFV path launched a serving kernel")
    peak = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
            if device.type == "cuda" else "not measured")
    print(f"genfv: peak memory allocated {peak}; hand-written kernel launches 0 "
          f"(the path runs none)")
    print(json.dumps({"genfv_rounds": [r for *_, r in rounds]}))
    return runner, rounds


def genfv_planner_contract(runner, rounds):
    """The card's float64 plans of phase 6's rounds against the numpy
    planner on the same fleets."""
    for pending, b_prev, plan, r in rounds:
        t0 = time.perf_counter()
        ref = plan_round(runner.cfg, pending.fleet, runner.model_bits,
                         runner.cfg.local_steps, b_prev=b_prev,
                         alpha_override=pending.alpha, planner="numpy")
        np_ms = 1e3 * (time.perf_counter() - t0)
        what = f"planner round {r['round']}"
        require(np.array_equal(ref.alpha, plan.alpha) and ref.selected == plan.selected,
                f"{what}: alpha differs")
        err = max([float(np.abs(ref.l - plan.l).max(initial=0.0)),
                   float(np.abs(ref.phi - plan.phi).max(initial=0.0)),
                   abs(ref.t_bar - plan.t_bar)])
        require(err <= PLAN_ATOL, f"{what}: l/phi/t_bar differ by {err:.3e} > {PLAN_ATOL}")
        require(abs(ref.b_gen - plan.b_gen) <= 1, f"{what}: b_gen {plan.b_gen} vs {ref.b_gen}")
        print(f"{what}: card (torch, float64) vs numpy: alpha equal, l/phi/t_bar within "
              f"{err:.3e}, b_gen {plan.b_gen} vs {ref.b_gen}, bcd_iters {plan.bcd_iters} vs "
              f"{ref.bcd_iters}; numpy planner {np_ms:.2f} ms on the host")


LEDGER_INTS = ("selected", "b_gen", "dropped", "late", "rejected", "stale_merged",
               "stale_dropped", "bcd_iters")


def genfv_card_matches_cpu(device, run_kw=GENFV_REDUCED, faults=None, what="reduced",
                           runner_kw=lambda d: {}):
    """The reduced run on the card and on the CPU from the same weights;
    each round starts both from the CPU's round-start parameters.
    `runner_kw(d)` gives the runner on device d its other arguments (the
    ddpm run's generator and service); the generated pools are held to
    GEN_POOL_TOL."""
    cpu = torch.device("cpu")
    runners = {d: GenFVRunner(RunConfig(**run_kw), faults=faults, device=d, **runner_kw(d))
               for d in (cpu, device)}
    worst_p = worst_l = worst_g = 0.0
    ledger = []
    for t in range(run_kw["rounds"]):
        runners[device].server.params = tree_map(lambda x: x.to(device),
                                                 runners[cpu].server.params)
        logs = {d: r.run_round(t) for d, r in runners.items()}
        for f in LEDGER_INTS:
            require(getattr(logs[cpu], f) == getattr(logs[device], f),
                    f"card vs CPU ({what}) round {t}: {f} {getattr(logs[device], f)} != "
                    f"{getattr(logs[cpu], f)}")
        require(logs[cpu].t_round == logs[device].t_round,
                f"card vs CPU ({what}) round {t}: t_round differs")
        dl = abs(logs[device].loss - logs[cpu].loss) / max(abs(logs[cpu].loss), 1e-30)
        dp = float((_flat(runners[device].server.params).cpu()
                    - _flat(runners[cpu].server.params)).abs().max())
        require(dl <= GENFV_LOSS_RTOL and dp <= GENFV_PARAM_TOL,
                f"card vs CPU ({what}) round {t}: loss {dl:.3e} (rtol {GENFV_LOSS_RTOL}), "
                f"params {dp:.3e} (tol {GENFV_PARAM_TOL})")
        worst_p, worst_l = max(worst_p, dp), max(worst_l, dl)
        if runners[cpu].server.pool_imgs is not None:
            dg = float(np.abs(runners[device].server.pool_imgs
                              - runners[cpu].server.pool_imgs).max())
            require(dg <= GEN_POOL_TOL, f"card vs CPU ({what}) round {t}: generated images "
                                        f"{dg:.3e} > {GEN_POOL_TOL}")
            worst_g = max(worst_g, dg)
        ledger.append(tuple(getattr(logs[device], f) for f in LEDGER_INTS))
    if faults is not None:
        totals = {f: sum(row[LEDGER_INTS.index(f)] for row in ledger)
                  for f in ("late", "rejected", "stale_merged")}
        require(all(totals.values()),
                f"card vs CPU ({what}): the run missed a fault branch {totals}")
    print(f"genfv card == CPU ({what}, {run_kw['rounds']} rounds): "
          f"{', '.join(LEDGER_INTS)} and t_round equal {ledger}; loss within "
          f"{worst_l:.3e} relative (tol {GENFV_LOSS_RTOL}), params within {worst_p:.3e} "
          f"(tol {GENFV_PARAM_TOL}), generated images within {worst_g:.3e} (tol {GEN_POOL_TOL})")
    return {"loss_rel": worst_l, "params_max_abs": worst_p, "images_max_abs": worst_g}


def genfv_bucket_invariance(runner):
    """One K=5 fleet step at full width at bucket 8, again at bucket 8, and
    at bucket 16, with cuDNN's default algorithms (held to BUCKET_TOL) and
    deterministic ones (held bitwise)."""
    eng = runner.engine
    rng = np.random.default_rng(0)
    parts = [i for i, (_, y) in enumerate(runner.client_data) if len(y) >= 2][:5]
    bis, bls = zip(*[eng.sample_batches(rng, *runner.client_data[i]) for i in parts])
    rhos = data_weights([runner.sizes[i] for i in parts])
    emd_bar = float(np.mean(emd_many(np.stack([runner.hists[i] for i in parts]))))
    g = runner.server.params
    aug = tree_map(lambda x: 0.5 * x, g)
    outs = [_flat(eng.run(g, list(bis), list(bls), rhos, emd_bar, aug, bucket=kb,
                         guard=False)[0])
            for kb in (8, 8, 16)]
    d_repeat = float((outs[0] - outs[1]).abs().max())
    d_bucket = float((outs[0] - outs[2]).abs().max())
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        det = [_flat(eng.run(g, list(bis), list(bls), rhos, emd_bar, aug, bucket=kb,
                             guard=False)[0])
               for kb in (8, 8, 16)]
    d_det_repeat = float((det[0] - det[1]).abs().max())
    d_det_bucket = float((det[0] - det[2]).abs().max())
    print(f"genfv bucket invariance (K=5, full width): bucket 8 vs 16 max |delta| "
          f"{d_bucket:.3e}, bucket 8 twice {d_repeat:.3e} (tol {BUCKET_TOL}); with "
          f"cudnn.deterministic: 8 vs 16 {d_det_bucket:.3e}, 8 twice {d_det_repeat:.3e} "
          f"(bitwise)")
    require(all(bool(torch.isfinite(o).all()) for o in outs + det), "non-finite aggregate")
    require(max(d_bucket, d_repeat) <= BUCKET_TOL,
            f"bucket invariance: {max(d_bucket, d_repeat):.3e} > {BUCKET_TOL}")
    require(d_det_bucket == 0.0 and d_det_repeat == 0.0,
            "deterministic cuDNN: the aggregate is not bitwise across buckets")


# The faulted rounds: mixed_stress's probabilities from round 0 with seed
# 23, picked on the CPU (fault draws, selections and the ledger do not
# depend on the device) so that two full-width rounds see a poisoned update
# rejected inside the fleet step in both rounds, late updates buffered in
# round 0 and merged in round 1 (inside a guarded fleet step), and a forced
# departure in round 1. Full width on CIFAR-10's training size; 1,000 test
# images instead of 10,000 and 2 rounds, to keep the phase short.
GENFV_FAULT_SPEC = FaultSpec(seed=23, straggler_prob=0.2, straggler_slowdown=3.0,
                             outage_prob=0.2, departure_prob=0.1, poison_prob=0.1)
GENFV_FAULT_RUN = dict(width_mult=1.0, train_size=50_000, test_size=1_000, rounds=2)
# The reduced faulted run (card against CPU): 3 rounds reach a late update,
# its merge and a rejection (genfv_card_matches_cpu requires all three).
GENFV_FAULT_REDUCED = dict(GENFV_REDUCED, rounds=3)
CKPT_DIR = ROOT / "build" / "genfv_ckpt"


class GuardRecorder:
    """Stands in for a runner's FleetEngine and records each fleet step:
    which batches carried the injected poison (all NaN) and the finite mask
    it returned."""

    def __init__(self, engine):
        self.engine, self.steps = engine, []

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def run(self, global_params, imgs_list, *args, **kw):
        out = self.engine.run(global_params, imgs_list, *args, **kw)
        self.steps.append({"poisoned": [bool(np.isnan(b).all()) for b in imgs_list],
                           "finite": out[2].tolist()})
        return out


def _round_spans(obs, t):
    """The tracer's spans of round t: name -> (ms, tags)."""
    return {e["name"]: (1e3 * e["dur"], e["tags"]) for e in obs.events
            if e["ph"] == "X" and e["tags"].get("round") == t}


def _timed_round(runner, t, device):
    sync(device)
    t0 = time.perf_counter()
    log = runner.run_round(t)
    sync(device)
    return log, 1e3 * (time.perf_counter() - t0)


def genfv_faulted(device):
    """GENFV_FAULT_RUN under GENFV_FAULT_SPEC with cuDNN's default
    algorithms, traced by the port's Obs; every fleet step's finite mask
    must equal the injected poison."""
    obs = Obs(meta={"phase": "genfv_faults"})
    t0 = time.perf_counter()
    runner = GenFVRunner(RunConfig(**GENFV_FAULT_RUN), faults=GENFV_FAULT_SPEC, obs=obs,
                         device=device)
    rec = GuardRecorder(runner.engine)
    runner.engine = rec
    print(f"genfv faults: width {runner.run.width_mult}, cifar10 {GENFV_FAULT_RUN['train_size']}/"
          f"{GENFV_FAULT_RUN['test_size']} images, {GENFV_FAULT_RUN['rounds']} rounds, "
          f"{GENFV_FAULT_SPEC}; runner built in {time.perf_counter() - t0:.1f} s")
    rounds, departed = [], 0
    for t in range(GENFV_FAULT_RUN["rounds"]):
        n_steps = len(rec.steps)
        log, round_ms = _timed_round(runner, t, device)
        spans = _round_spans(obs, t)
        k = spans["round/local_sgd"][1]["selected"]
        departed += int(runner.faults.draw(t, k).departed.sum())
        steps = rec.steps[n_steps:]
        r = {f: getattr(log, f) for f in ("round", "selected", "dropped", "late", "rejected",
                                          "stale_merged", "stale_dropped", "b_gen", "t_bar",
                                          "t_round", "bcd_iters", "loss", "accuracy")}
        r.update({"bucket": bucket_size(log.selected) if log.selected else 0,
                  "poisoned": bool(steps and any(steps[0]["poisoned"])),
                  "finite": steps[0]["finite"] if steps else None,
                  "round_ms": round_ms})
        for name in ("plan", "generate", "local_sgd", "aggregate", "world_step", "eval"):
            r[f"{name}_ms"] = spans[f"round/{name}"][0]
        rounds.append(r)
        print(f"genfv faults round {t}: selected {log.selected} (bucket {r['bucket']}), "
              f"dropped {log.dropped}, late {log.late}, rejected {log.rejected}, stale merged "
              f"{log.stale_merged}, poison in the fleet step {r['poisoned']} finite "
              f"{r['finite']}, t_bar "
              f"{log.t_bar:.4f} s, t_round {log.t_round:.4f} s, loss {log.loss:.4f}, accuracy "
              f"{log.accuracy:.4f}; ms: plan {r['plan_ms']:.2f}, generate + omega_a "
              f"{r['generate_ms']:.2f}, late training {r['local_sgd_ms']:.2f}, fleet step + "
              f"merge {r['aggregate_ms']:.2f}, eval {r['eval_ms']:.2f}, round {round_ms:.2f}")
        require(math.isfinite(log.loss) and 0.0 <= log.accuracy <= 1.0,
                f"genfv faults round {t}: loss {log.loss}, accuracy {log.accuracy}")
    require(any(any(st["poisoned"]) for st in rec.steps),
            "genfv faults: no fleet step carried a poisoned update")
    for st in rec.steps:
        require(st["finite"] == [not p for p in st["poisoned"]],
                f"genfv faults: finite mask {st['finite']} != injected poison {st['poisoned']}")
    totals = {f: sum(r[f] for r in rounds) for f in ("rejected", "late", "stale_merged")}
    require(all(totals.values()) and departed > 0,
            f"genfv faults: the run missed a fault branch {totals}, forced departures {departed}")
    require(all(x.device == device for x in tree_leaves(runner.server.params)),
            "the runner's parameters left the card")
    require(bool(torch.isfinite(_flat(runner.server.params)).all()), "non-finite global parameters")
    require(obs.open_spans == 0, "open spans after the run")
    print(f"genfv faults: {len(rec.steps)} fleet steps, "
          f"{sum(any(st['poisoned']) for st in rec.steps)} with poison, finite == injected "
          f"poison in each; "
          f"rejected {totals['rejected']}, late {totals['late']}, merged "
          f"{totals['stale_merged']}, forced departures {departed}")
    return runner, rec.engine, rounds


def _unguarded_eq4(stacked, weights, aug, aug_weight, fallback):
    """Eq. 4 without the finiteness guard's selects, the JAX package's
    unguarded chain: fed = w0*s0; fed = fed + wi*si; ... in float32.
    Returns an all-true finite mask, as a clean fleet gives."""
    s32 = stacked.float()
    ws = [float(np.float32(w)) for w in weights]
    fed = ws[0] * s32[0]
    for i in range(1, len(ws)):
        fed = fed + ws[i] * s32[i]
    out = fed + float(np.float32(aug_weight)) * aug.float()
    return out.to(stacked.dtype), torch.ones(len(ws), dtype=torch.bool, device=stacked.device)


def _in_turns(calls, device):
    """Each call of `calls` (name -> fn) twice, in turns A, B, B, A, timed
    on the host's clock around a device sync: name -> ([ms, ms], last out)."""
    names = list(calls)
    ms, outs = {n: [] for n in names}, {}
    for name in names + names[::-1]:
        sync(device)
        t0 = time.perf_counter()
        outs[name] = calls[name]()
        sync(device)
        ms[name].append(1e3 * (time.perf_counter() - t0))
    return ms, outs


def genfv_poisoned_step(runner, engine, device):
    """Full-width fleet steps at K=5, bucket 8: (1) vehicle 2's batches
    poisoned, against the step of the other four with their weights
    renormalised (within BUCKET_TOL, finite mask exact); (2) the clean
    five, guarded, against the same step unguarded (`guard=False`, what a
    step without injected poison runs; within BUCKET_TOL: cuDNN's default
    wgrad differs run to run); (3) on the clean step's stacked [8, P]
    buffer, eq. 4 guarded, unguarded (the same chain with an all-true
    mask) and the plain chain without the guard's selects (the JAX
    package's unguarded eq. 4), bitwise, and each timed alone. Each pair is timed in
    turns. Also times the stale merge of two full-width updates."""
    rng = np.random.default_rng(1)
    parts = [i for i, (_, y) in enumerate(runner.client_data) if len(y) >= 2][:5]
    bis, bls = zip(*[engine.sample_batches(rng, *runner.client_data[i]) for i in parts])
    rhos = data_weights([runner.sizes[i] for i in parts])
    emd_bar = float(np.mean(emd_many(np.stack([runner.hists[i] for i in parts]))))
    g = runner.server.params
    aug = tree_map(lambda x: 0.5 * x, g)
    bad = 2
    keep = [i for i in range(len(parts)) if i != bad]
    poisoned = list(bis)
    poisoned[bad] = np.full_like(bis[bad], np.nan)
    ms, outs = _in_turns({
        "poisoned": lambda: engine.run(g, poisoned, list(bls), rhos, emd_bar, aug, bucket=8,
                                       guard=True),
        "clean4": lambda: engine.run(g, [bis[i] for i in keep], [bls[i] for i in keep],
                                     rhos[keep] / rhos[keep].sum(), emd_bar, aug, bucket=8,
                                     guard=True)},
        device)
    finite = outs["poisoned"][2].tolist()
    require(finite == [i != bad for i in range(len(parts))],
            f"poisoned fleet step: finite {finite}, poisoned vehicle {bad}")
    d = float((_flat(outs["poisoned"][0]) - _flat(outs["clean4"][0])).abs().max())
    require(math.isfinite(d) and d <= BUCKET_TOL,
            f"poisoned fleet step: aggregate vs the renormalised clean one {d:.3e} > "
            f"{BUCKET_TOL}")

    captured = []

    def capture(stacked, *args, guard, **kw):
        captured[:] = [(stacked, args, kw)]
        return aggregate_stacked_guarded(stacked, *args, guard=guard, **kw)
    fleet_mod.aggregate_stacked_guarded = capture
    try:
        ms_clean, outs_clean = _in_turns({
            "guarded": lambda: engine.run(g, list(bis), list(bls), rhos, emd_bar, aug, bucket=8,
                                          guard=True),
            "unguarded": lambda: engine.run(g, list(bis), list(bls), rhos, emd_bar, aug,
                                            bucket=8, guard=False)}, device)
    finally:
        fleet_mod.aggregate_stacked_guarded = aggregate_stacked_guarded
    require(outs_clean["guarded"][2].all(), "clean fleet step: a vehicle was rejected")
    d_clean = float((_flat(outs_clean["guarded"][0])
                     - _flat(outs_clean["unguarded"][0])).abs().max())
    require(d_clean <= BUCKET_TOL,
            f"clean fleet step: guarded vs unguarded eq. 4 {d_clean:.3e} > {BUCKET_TOL}")
    stacked, args, kw = captured[0]
    eq4 = {"guarded": lambda: aggregate_stacked_guarded(stacked, *args, guard=True, **kw),
           "unguarded": lambda: aggregate_stacked_guarded(stacked, *args, guard=False, **kw),
           "plain": lambda: _unguarded_eq4(stacked, *args, **kw)}
    outs_eq4 = [fn()[0] for fn in eq4.values()]
    require(all(torch.equal(outs_eq4[0], o) for o in outs_eq4[1:]),
            "eq. 4 on the clean stacked buffer: the guard changed a bit")
    del outs_eq4
    eq4_ms = {name: time_ms(fn, device) for name, fn in eq4.items()}
    del captured, stacked
    stale = [tree_map(lambda x: x + 1e-3, g), tree_map(lambda x: x - 1e-3, g)]
    merge_ms = time_ms(lambda: add_weighted(g, stale, [0.125, 0.0625]), device)
    out = {"poisoned_step_ms": ms["poisoned"], "clean4_step_ms": ms["clean4"],
           "poisoned_vs_clean4_max_abs": d, "guarded_step_ms": ms_clean["guarded"],
           "unguarded_step_ms": ms_clean["unguarded"], "guarded_vs_unguarded_max_abs": d_clean,
           "eq4_guarded_ms": eq4_ms["guarded"], "eq4_unguarded_ms": eq4_ms["unguarded"],
           "eq4_plain_ms": eq4_ms["plain"], "stale_merge_ms": merge_ms}
    print(f"genfv poisoned fleet step (K=5, bucket 8, vehicle {bad} poisoned): finite {finite}; "
          f"aggregate vs the clean four renormalised max |delta| {d:.3e} (tol {BUCKET_TOL}); "
          f"poisoned {ms['poisoned'][0]:.2f}/{ms['poisoned'][1]:.2f} ms, clean four "
          f"{ms['clean4'][0]:.2f}/{ms['clean4'][1]:.2f} ms (in turns)")
    print(f"genfv clean fleet step (K=5, bucket 8): guarded vs unguarded eq. 4 max |delta| "
          f"{d_clean:.3e} (tol {BUCKET_TOL}); step guarded {ms_clean['guarded'][0]:.2f}/"
          f"{ms_clean['guarded'][1]:.2f} ms, unguarded {ms_clean['unguarded'][0]:.2f}/"
          f"{ms_clean['unguarded'][1]:.2f} ms (in turns); eq. 4 alone on its [8, P] buffer "
          f"guarded {eq4_ms['guarded']:.4f} ms, unguarded (all-true mask) "
          f"{eq4_ms['unguarded']:.4f} ms, the plain chain {eq4_ms['plain']:.4f} ms, "
          f"bitwise equal; stale merge of 2 full-width updates {merge_ms:.4f} ms")
    return out


def genfv_sequential_round(vec_rounds, device):
    """Round 0 of the faulted run on the sequential path (vectorized=False)
    at full width: the integer ledger equals the vectorized run's."""
    runner = GenFVRunner(RunConfig(vectorized=False, **GENFV_FAULT_RUN), faults=GENFV_FAULT_SPEC,
                         device=device)
    log, ms = _timed_round(runner, 0, device)
    for f in LEDGER_INTS:
        require(getattr(log, f) == vec_rounds[0][f],
                f"sequential round 0: {f} {getattr(log, f)} != vectorized {vec_rounds[0][f]}")
    require(math.isfinite(log.loss), f"sequential round 0: loss {log.loss}")
    print(f"genfv sequential round 0 (width {GENFV_FAULT_RUN['width_mult']}): "
          f"{', '.join(LEDGER_INTS)} equal the vectorized "
          f"run's; loss {log.loss:.4f} (vectorized {vec_rounds[0]['loss']:.4f}), round {ms:.2f} ms")
    return ms


def genfv_resume_and_tracer(device):
    """Under deterministic cuDNN: an untraced run that saves a checkpoint
    after round 0 (late updates in its stale buffer) and a traced run, held
    bitwise equal; then round 1 again from that checkpoint, four times in
    turns (a fresh untraced runner, the traced runner twice, the untraced
    one again), each held bitwise to the uninterrupted run. The turns time
    the same warm round with and without the tracer."""
    run = RunConfig(**GENFV_FAULT_RUN)
    rounds = GENFV_FAULT_RUN["rounds"]
    path = str(CKPT_DIR / "runner.npz")
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        plain = GenFVRunner(run, faults=GENFV_FAULT_SPEC, device=device)
        plain.run_round(0)
        n_stale = len(plain.stale)
        sync(device)
        t0 = time.perf_counter()
        plain.save_checkpoint(path)
        save_ms = 1e3 * (time.perf_counter() - t0)
        for t in range(1, rounds):
            plain.run_round(t)
        want_logs, want = list(plain.logs), _flat(plain.server.params).clone()
        traced = GenFVRunner(run, faults=GENFV_FAULT_SPEC, obs=Obs(), device=device)
        for t in range(rounds):
            traced.run_round(t)
        require(traced.logs == want_logs and torch.equal(_flat(traced.server.params), want),
                "deterministic cuDNN: the traced run differs from the untraced run")
        resumed = GenFVRunner(run, faults=GENFV_FAULT_SPEC, device=device)
        ms = {"untraced": [], "traced": []}
        load_ms = []
        for name in ("untraced", "traced", "traced", "untraced"):
            r = resumed if name == "untraced" else traced
            sync(device)
            t0 = time.perf_counter()
            nxt = r.load_checkpoint(path)
            sync(device)
            load_ms.append(1e3 * (time.perf_counter() - t0))
            require(nxt == 1 and len(r.stale) == n_stale > 0,
                    f"resume: next round {nxt}, stale entries {len(r.stale)} vs {n_stale}")
            require(all(x.device == device for e in r.stale.entries
                        for x in tree_leaves(e.params)), "resume: stale entries off the card")
            for t in range(1, rounds):
                ms[name].append(_timed_round(r, t, device)[1])
            require(r.logs == want_logs and torch.equal(_flat(r.server.params), want),
                    f"deterministic cuDNN: the resumed run ({name}) differs from the "
                    f"uninterrupted run")
            require(all(x.device == device for x in tree_leaves(r.server.params)),
                    "resume: parameters off the card")
    size_mb = Path(path).stat().st_size / 1e6
    Path(path).unlink()
    out = {"traced_round_ms": ms["traced"], "untraced_round_ms": ms["untraced"],
           "tracer_overhead_ms_per_round": statistics.mean(ms["traced"])
           - statistics.mean(ms["untraced"]),
           "checkpoint_save_ms": save_ms, "checkpoint_load_ms": load_ms,
           "checkpoint_mb": size_mb, "stale_entries": n_stale}
    print(f"genfv deterministic cuDNN: traced == untraced, resumed == uninterrupted 4 times "
          f"(every RoundLog field and the parameters, bitwise); checkpoint after round 0 with "
          f"{n_stale} stale entries, {size_mb:.1f} MB, save {save_ms:.2f} ms, load "
          f"{', '.join(f'{x:.2f}' for x in load_ms)} ms; round 1 from the checkpoint in turns: "
          f"untraced {ms['untraced'][0]:.2f}/{ms['untraced'][1]:.2f} ms, traced "
          f"{ms['traced'][0]:.2f}/{ms['traced'][1]:.2f} ms")
    return out


def genfv_faults(device):
    t_start = time.perf_counter()
    ops.flash_attention.launches = 0
    ops.rglru_scan.launches = 0
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    runner, engine, rounds = genfv_faulted(device)
    step = genfv_poisoned_step(runner, engine, device)
    del runner, engine
    torch.cuda.empty_cache()
    seq_ms = genfv_sequential_round(rounds, device)
    det = genfv_resume_and_tracer(device)
    torch.cuda.empty_cache()
    genfv_card_matches_cpu(device, GENFV_FAULT_REDUCED, GENFV_FAULT_SPEC, what="reduced, faulted")
    require(ops.flash_attention.launches == 0 and ops.rglru_scan.launches == 0,
            "the faulted GenFV path launched a serving kernel")
    phase_s = time.perf_counter() - t_start
    print(f"genfv faults: phase {phase_s:.1f} s; hand-written kernel launches 0")
    print(json.dumps({"genfv_fault_rounds": rounds,
                      "genfv_faults": {**step, **det, "sequential_round_ms": seq_ms,
                                       "phase_s": phase_s}}))


def genfv(device):
    runner, rounds = genfv_full_width(device)
    genfv_planner_contract(runner, rounds)
    genfv_bucket_invariance(runner)
    del runner
    torch.cuda.empty_cache()
    genfv_card_matches_cpu(device)
    genfv_faults(device)
    torch.cuda.empty_cache()
    genfv_ddpm(device)
    torch.cuda.empty_cache()
    genfv_stream_sweep(device)


# ---------------------------------------------------------------------------
# Phase 6, continued: the GenFV round loop with the DDPM generator
# ---------------------------------------------------------------------------
# The full-width run of phase 6 with generator="ddpm": the runner's DDPM
# (200 timesteps, base 16, pretrained 80 steps on 512 reference images) at
# 50 strided sampling steps, eq. 48 priced with the card's measured t_image.
GENFV_DDPM = dict(GENFV_FULL, generator="ddpm")
# Sampler throughput: the runner's width and init_unet's default (base 64:
# channels 64/128/256, embedding 256), at the runner's 50 steps.
SAMPLER_BASES = (16, 64)
SAMPLER_BUCKETS = (16, 64, 256)
SAMPLER_STEPS = 50
# The ddpm run on the card against the CPU: the reduced run, the runner's
# DDPM with the card's pretrained parameters on both, 10 sampling steps,
# t_image fixed at the assumed service's 0.05 s.
GENFV_DDPM_REDUCED = dict(GENFV_REDUCED, generator="ddpm", sampler_steps=10)
# Generated images (in [-1, 1]) on the card against the CPU, from the same
# parameters and host noise (1.609e-06 apart at 10 steps on an H100).
GEN_POOL_TOL = 1e-4
# Fused == per-label == offset shard and padding on the card: cuDNN picks
# its algorithms by batch size, default or deterministic alike, so passes
# at other batch sizes differ (3.636e-06 at 50 steps on an H100, in both
# settings) and are held to this tolerance; the same pass twice is held
# bitwise. (On the CPU all four are bitwise, tests/test_torch_genfv_gen.py.)
GEN_INVARIANCE_TOL = 1e-4


def _max_diff(trees):
    a, b = (_flat(t) for t in trees)
    return float((a - b).abs().max())


def genfv_pretraining(device):
    """The runner's reference-pool pretraining on the card, twice with the
    caller's cuDNN flags at their defaults and twice set deterministic: ms,
    final loss, and how far each pair's parameters lie apart (both held
    bitwise: pretrain_ddpm scopes deterministic cuDNN itself)."""
    ddpm = gen_service.runner_ddpm(10)
    kw = dict(steps=gen_service.PRETRAIN_STEPS, ref_size=gen_service.PRETRAIN_REF,
              seed=gen_service.PRETRAIN_SEED, device=device)
    runs = {}
    for name in ("default", "default", "deterministic", "deterministic"):
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=name == "deterministic", allow_tf32=False):
            sync(device)
            t0 = time.perf_counter()
            params, losses = pretrain_ddpm(ddpm, **kw)
            sync(device)
        runs.setdefault(name, []).append((params, losses, 1e3 * (time.perf_counter() - t0)))
    out = {"pretrain_ms": [r[2] for v in runs.values() for r in v],
           "pretrain_final_loss": runs["default"][0][1][-1],
           "pretrain_first_loss": runs["default"][0][1][0]}
    for name, ((pa, la, _), (pb, lb, _)) in runs.items():
        out[f"pretrain_{name}_twice_max_abs"] = _max_diff((pa, pb))
        out[f"pretrain_{name}_twice_bitwise"] = out[f"pretrain_{name}_twice_max_abs"] == 0.0
    require(all(math.isfinite(x) for v in runs.values() for r in v for x in r[1]),
            "pretraining: non-finite loss")
    # any process reconstructs the pretrained generator: pretrain_ddpm runs
    # under deterministic cuDNN whatever flags its caller set
    require(out["pretrain_deterministic_twice_bitwise"] and out["pretrain_default_twice_bitwise"],
            "two pretrainings differ")
    print(f"genfv ddpm pretraining ({ddpm.timesteps} timesteps, base {ddpm.base_width}, "
          f"{kw['steps']} steps on {kw['ref_size']} images): "
          f"{', '.join(f'{x:.2f}' for x in out['pretrain_ms'])} ms (default, default, "
          f"deterministic, deterministic); loss {out['pretrain_first_loss']:.4f} -> "
          f"{out['pretrain_final_loss']:.4f}; two pretrainings apart by "
          f"{out['pretrain_default_twice_max_abs']:.3e} (caller's cuDNN default), "
          f"{out['pretrain_deterministic_twice_max_abs']:.3e} (caller's cuDNN deterministic)")
    return out, runs["default"][0][0]


def genfv_ddpm_full_width(device):
    """GENFV_DDPM through the runner's entry point, traced by Obs: the
    runner pretrains (or takes the cached parameters) and measures t_image
    on this card; each round prints its generation and stages."""
    obs = Obs(meta={"phase": "genfv_ddpm"})
    t0 = time.perf_counter()
    runner = GenFVRunner(RunConfig(**GENFV_DDPM), obs=obs, device=device)
    build_s = time.perf_counter() - t0
    gen = runner.server.generator
    require(isinstance(gen, BatchedDDPMGenerator) and isinstance(runner.svc, MeasuredService),
            "genfv ddpm: the runner did not build the DDPM service")
    require(all(x.device == device for x in tree_leaves(gen.params)),
            "genfv ddpm: the generator's parameters are not on the card")
    print(f"genfv ddpm: width {runner.run.width_mult}, DDPM {gen.ddpm}, {gen.sampler_steps} "
          f"sampling steps; measured t_image {runner.svc.t_image * 1e3:.4f} ms an image "
          f"(bucket {CALIB_BUCKET}); runner built in {build_s:.1f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rounds = []
    for t in range(GENFV_DDPM["rounds"]):
        log, round_ms = _timed_round(runner, t, device)
        spans = _round_spans(obs, t)
        r = {f: getattr(log, f) for f in ("round", "selected", "b_gen", "t_bar", "loss",
                                          "accuracy")}
        r.update({"images": log.b_gen, "bucket": bucket_size(log.b_gen) if log.b_gen else 0,
                  "round_ms": round_ms})
        for name in ("plan", "generate", "local_sgd", "aggregate", "world_step", "eval"):
            r[f"{name}_ms"] = spans[f"round/{name}"][0]
        r["sample_ms"] = spans["round/generate/sample"][0] if log.b_gen else 0.0
        r["omega_a_ms"] = r["generate_ms"] - r["sample_ms"]
        rounds.append(r)
        print(f"genfv ddpm round {t}: selected {log.selected}, b_gen {log.b_gen} images "
              f"(bucket {r['bucket']}), t_bar {log.t_bar:.4f} s, loss {log.loss:.4f}, accuracy "
              f"{log.accuracy:.4f}; ms: plan {r['plan_ms']:.2f}, sampling {r['sample_ms']:.2f}, "
              f"omega_a {r['omega_a_ms']:.2f}, fleet step {r['aggregate_ms']:.2f}, eval "
              f"{r['eval_ms']:.2f}, round {round_ms:.2f}")
        require(math.isfinite(log.loss) and 0.0 <= log.accuracy <= 1.0,
                f"genfv ddpm round {t}: loss {log.loss}, accuracy {log.accuracy}")
    require(sum(r["b_gen"] for r in rounds) > 0, "genfv ddpm: no round generated")
    pool = runner.server.pool_imgs
    require(pool.shape == (sum(r["b_gen"] for r in rounds), 32, 32, 3)
            and bool(np.isfinite(pool).all()) and float(np.abs(pool).max()) <= 1.0,
            "genfv ddpm: generated pool out of shape or range")
    require(obs.metrics.counter_value("gen/images") == len(pool), "genfv ddpm: gen/images")
    require(bool(torch.isfinite(_flat(runner.server.params)).all()),
            "genfv ddpm: non-finite global parameters")
    peak = (torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None)
    return runner, {"t_image_s": runner.svc.t_image, "runner_build_s": build_s, "rounds": rounds,
                    "peak_gib": peak}


def genfv_sampler_throughput(device):
    """The bucketed sampler at SAMPLER_STEPS steps, per base width and
    bucket: the host's noise draw and the pass on the card (noise upload,
    denoising loop, images back to the host) timed apart, the pass as the
    best of two after a warm-up, and the noise's upload alone; images/s and
    ms per denoising step of the pass; peak memory."""
    out = []
    for base in SAMPLER_BASES:
        ddpm = DDPM(timesteps=gen_service.RUNNER_TIMESTEPS, num_classes=10, base_width=base)
        params = make_ddpm(np.random.default_rng(base), ddpm, device)
        for bucket in SAMPLER_BUCKETS:
            labels = np.arange(bucket) % 10
            key = gen_service.gen_round_key(0, 0)
            t0 = time.perf_counter()
            noise = image_noise(key, 0, bucket, SAMPLER_STEPS)
            noise_ms = 1e3 * (time.perf_counter() - t0)
            sync(device)
            t0 = time.perf_counter()
            torch.from_numpy(noise).to(device)
            sync(device)
            upload_ms = 1e3 * (time.perf_counter() - t0)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            imgs = sample_schedule(params, ddpm, key, labels, SAMPLER_STEPS, noise=noise)
            passes = []
            for _ in range(2):
                t0 = time.perf_counter()
                again = sample_schedule(params, ddpm, key, labels, SAMPLER_STEPS, noise=noise)
                passes.append(1e3 * (time.perf_counter() - t0))
            require(bool(np.isfinite(imgs).all()), f"sampler base {base} bucket {bucket}: non-finite")
            r = {"base": base, "bucket": bucket, "steps": SAMPLER_STEPS, "noise_ms": noise_ms,
                 "noise_upload_ms": upload_ms,
                 "pass_ms": min(passes), "images_per_s": bucket / (min(passes) / 1e3),
                 "ms_per_step": min(passes) / SAMPLER_STEPS,
                 "noise_mb": noise.nbytes / 1e6,
                 "repeat_max_abs": float(np.abs(imgs - again).max()),
                 "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                              if device.type == "cuda" else None)}
            out.append(r)
            print(f"sampler base {base}, bucket {bucket}, {SAMPLER_STEPS} steps: pass "
                  f"{r['pass_ms']:.2f} ms ({r['images_per_s']:.1f} images/s, "
                  f"{r['ms_per_step']:.3f} ms a denoising step), host noise "
                  f"{noise_ms:.2f} ms for {r['noise_mb']:.1f} MB (its upload alone "
                  f"{upload_ms:.2f} ms), peak "
                  f"{'not measured' if r['peak_gib'] is None else format(r['peak_gib'], '.2f') + ' GiB'}"
                  f", same pass twice max |delta| {r['repeat_max_abs']:.3e}")
        del params
    return out


def genfv_gen_invariance(params, ddpm, device):
    """Image j depends on (params, key, start + j, label) only: one fused
    pass over a multi-label schedule against the per-label passes, an
    offset shard, and the schedule padded to a larger bucket; with cuDNN's
    default algorithms and with deterministic ones."""
    key = gen_service.gen_round_key(0, 1)
    counts = np.array([5, 0, 3, 9, 1, 2, 0, 4, 6, 1])
    labels = np.repeat(np.arange(10), counts)
    out = {}
    for name in ("default", "deterministic"):
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=name == "deterministic", allow_tf32=False):
            fused = sample_schedule(params, ddpm, key, labels, SAMPLER_STEPS)
            parts, off = [], 0
            for lab, c in enumerate(counts):
                if c:
                    parts.append(sample_schedule(params, ddpm, key, [lab] * int(c),
                                                 SAMPLER_STEPS, start=off))
                    off += int(c)
            shard = sample_schedule(params, ddpm, key, labels[7:20], SAMPLER_STEPS, start=7)
            padded = sample_schedule(params, ddpm, key, labels, SAMPLER_STEPS, bucket=128)
            twice = sample_schedule(params, ddpm, key, labels, SAMPLER_STEPS)
        d = {"per_label": float(np.abs(fused - np.concatenate(parts)).max()),
             "shard": float(np.abs(fused[7:20] - shard).max()),
             "padding": float(np.abs(fused - padded).max()),
             "twice": float(np.abs(fused - twice).max())}
        out[name] = d
        require(max(d.values()) <= GEN_INVARIANCE_TOL and d["twice"] == 0.0,
                f"sampler invariance ({name} cuDNN): {d} > {GEN_INVARIANCE_TOL}, or the "
                f"same pass twice not bitwise")
    print(f"genfv ddpm sampler invariance ({len(labels)} images, bucket "
          f"{bucket_size(len(labels))}, {SAMPLER_STEPS} steps), max |delta| against the fused "
          f"pass: default cuDNN {out['default']}, deterministic cuDNN {out['deterministic']} "
          f"(tol {GEN_INVARIANCE_TOL}; the same pass twice bitwise)")
    return out


def genfv_ddpm_resume(device):
    """Under deterministic cuDNN, the reduced ddpm run (the runner's DDPM,
    its cached parameters, this card's measured t_image) stopped after
    round 0 and resumed in a fresh runner after the calibration file was
    rewritten with another t_image: the resumed runner prices eq. 48 with
    the checkpoint's t_image and replays the uninterrupted run bitwise."""
    run = RunConfig(**dict(GENFV_REDUCED, generator="ddpm", rounds=3))
    path = str(CKPT_DIR / "ddpm_runner.npz")
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        golden = GenFVRunner(run, device=device)
        want = golden.train().logs
        first = GenFVRunner(run, device=device)
        first.run_round(0)
        first.save_checkpoint(path)
        t_image = first.svc.t_image
        key = _calib_key(golden.server.generator.ddpm, run.sampler_steps, CALIB_BUCKET, device)
        entries = load_calibration()
        entries[key] = dict(entries[key], t_image=3.0 * t_image)
        save_calibration(entries)
        resumed = GenFVRunner(run, device=device)
        require(resumed.svc.t_image == 3.0 * t_image, "resume: the rewritten calibration")
        require(resumed.load_checkpoint(path) == 1, "resume: next round")
        require(resumed.svc.t_image == t_image, "resume: t_image not restored from the checkpoint")
        got = resumed.train().logs
    Path(path).unlink()
    require(got == want and torch.equal(_flat(resumed.server.params), _flat(golden.server.params))
            and np.array_equal(resumed.server.pool_imgs, golden.server.pool_imgs),
            "deterministic cuDNN: the resumed ddpm run differs from the uninterrupted run")
    print(f"genfv ddpm resume (deterministic cuDNN, {run.rounds} rounds, b_gen "
          f"{[l.b_gen for l in want]}): t_image {t_image * 1e3:.4f} ms restored from the "
          f"checkpoint over a rewritten calibration; every RoundLog field, the parameters and "
          f"the generated pool bitwise")


def genfv_ddpm(device):
    """Phase genfv_ddpm, under a temporary REPRO_ARTIFACTS so that every
    call measures t_image afresh."""
    t_start = time.perf_counter()
    ops.flash_attention.launches = 0
    ops.rglru_scan.launches = 0
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    old = os.environ.get("REPRO_ARTIFACTS")
    with tempfile.TemporaryDirectory() as artifacts:
        os.environ["REPRO_ARTIFACTS"] = artifacts
        try:
            pre, params = genfv_pretraining(device)
            runner, full = genfv_ddpm_full_width(device)
            ddpm = runner.server.generator.ddpm
            del runner
            torch.cuda.empty_cache()
            inv = genfv_gen_invariance(params, ddpm, device)
            throughput = genfv_sampler_throughput(device)
            torch.cuda.empty_cache()
            steps = GENFV_DDPM_REDUCED["sampler_steps"]
            svc = MeasuredService(t_image=0.05, steps=steps)
            cpu_vs_card = genfv_card_matches_cpu(
                device, GENFV_DDPM_REDUCED, what="reduced, ddpm",
                runner_kw=lambda d: {"svc": svc, "generator": BatchedDDPMGenerator(
                    tree_map(lambda x: x.to(d), params), ddpm, seed=0, sampler_steps=steps)})
            genfv_ddpm_resume(device)
        finally:
            if old is None:
                os.environ.pop("REPRO_ARTIFACTS", None)
            else:
                os.environ["REPRO_ARTIFACTS"] = old
    require(ops.flash_attention.launches == 0 and ops.rglru_scan.launches == 0,
            "the ddpm GenFV path launched a serving kernel")
    phase_s = time.perf_counter() - t_start
    print(f"genfv ddpm: phase {phase_s:.1f} s; hand-written kernel launches 0 (the path runs none)")
    print(json.dumps({"genfv_ddpm": {**pre, **full, "sampler": throughput, "invariance": inv,
                                     "card_vs_cpu": cpu_vs_card, "phase_s": phase_s}}))


# ---------------------------------------------------------------------------
# Phase 6, continued: the streaming RSU and the experiment layer
# ---------------------------------------------------------------------------
# benchmarks/bench_stream.py's STREAM policy on its second headline pair
# (rush_hour + rush_hour_deep_fade), at full width on CIFAR-10's training
# size; 1,000 test images instead of 10,000 to keep the phase short, as
# genfv_faults cuts.
STREAM_POLICY = dict(quorum=0.6, cadence_s=0.1, deadline_slack=0.25, retry_budget=2)
GENFV_STREAM = dict(width_mult=1.0, train_size=50_000, test_size=1_000, rounds=3,
                    scenario="rush_hour", faults="rush_hour_deep_fade")
# The same pair at bench_stream's quick size, card against CPU; the numpy
# planner on both, so that the schedule is the host's on both.
STREAM_QUICK = dict(rounds=3, train_size=300, test_size=32, width_mult=0.0625,
                    scenario="rush_hour", faults="rush_hour_deep_fade", planner="numpy")
SMALL_FLEET = dict(batch_size=8, local_steps=2, num_vehicles=6)
# The full-width sweep: every registered scenario, 2 rounds, 1,000 test images.
SWEEP_SCENARIOS = ("highway_free_flow", "rush_hour", "urban_stop_go", "platoon", "sparse_rural")
GENFV_SWEEP = dict(width_mult=1.0, train_size=50_000, test_size=1_000, rounds=2)
# Sweep == per-cell, bitwise under deterministic cuDNN: two strategies of
# one scenario, which plan in one batched dispatch of 2 a round.
SWEEP_HOLD = dict(width_mult=0.25, rounds=2)
STAGES = ("stream/tick", "stream/retry", "stream/commit", "round/plan", "round/generate",
          "round/local_sgd", "round/aggregate", "round/world_step", "round/eval")


def _tree_bytes(tree):
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def stream_full_width(device, datasets):
    """D1: GENFV_STREAM through StreamEngine under STREAM_POLICY, traced by
    Obs, with cuDNN's default algorithms: per round the ladder rung, the
    quorum, the in-flight merges, late uploads and retries, span ms by
    stage, the in-flight queue's bytes on the card and peak memory."""
    obs = Obs(meta={"phase": "genfv_stream_sweep"})
    t0 = time.perf_counter()
    runner = GenFVRunner(RunConfig(**GENFV_STREAM), obs=obs, device=device, dataset_fn=datasets)
    eng = StreamEngine(runner, StreamConfig(**STREAM_POLICY))
    print(f"stream: width {runner.run.width_mult}, cifar10 {GENFV_STREAM['train_size']}/"
          f"{GENFV_STREAM['test_size']} images, {GENFV_STREAM['scenario']} + "
          f"{GENFV_STREAM['faults']}, {eng.scfg}; runner built in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats(device)
    rounds = []
    for t in range(GENFV_STREAM["rounds"]):
        sync(device)
        t0 = time.perf_counter()
        log = eng.run_round(t)
        sync(device)
        round_ms = 1e3 * (time.perf_counter() - t0)
        s = eng.slogs[-1]
        spans = _round_spans(obs, t)
        r = dict(vars(s), loss=log.loss, accuracy=log.accuracy, selected=log.selected,
                 dropped=log.dropped, rejected=log.rejected, t_bar=log.t_bar, round_ms=round_ms,
                 inflight=len(eng.inflight),
                 inflight_mb=sum(_tree_bytes(e.params) for e in eng.inflight) / 1e6,
                 peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
        r.update({f"{n}_ms": spans[n][0] for n in STAGES if n in spans})
        rounds.append(r)
        print(f"stream round {t}: rung {s.rung}, quorum {s.arrived}/{s.quorum_target}, "
              f"trained {log.selected}, dropped {log.dropped}, merged in-flight "
              f"{s.merged_inflight}, gap-absorbed {s.gap_merged}, stale dropped "
              f"{s.stale_dropped}, late {s.late}, retries {s.retries}, exhausted {s.exhausted}, "
              f"commit at {s.t_commit - s.t_start:.4f} s of t_bar {log.t_bar:.4f} s; loss "
              f"{log.loss:.4f}, accuracy {log.accuracy:.4f}; ms: "
              + ", ".join(f"{n} {spans[n][0]:.2f}" for n in STAGES if n in spans)
              + f", round {round_ms:.2f}; in flight {r['inflight']} updates, "
              f"{r['inflight_mb']:.1f} MB on the card; peak {r['peak_gib']:.2f} GiB")
        require(math.isfinite(log.loss) and 0.0 <= log.accuracy <= 1.0,
                f"stream round {t}: loss {log.loss}, accuracy {log.accuracy}")
    require(all(x.device == device for x in tree_leaves(runner.server.params))
            and all(x.device == device for e in eng.inflight for x in tree_leaves(e.params)),
            "stream: parameters or in-flight updates left the card")
    require(bool(torch.isfinite(_flat(runner.server.params)).all()), "stream: non-finite global")
    require(obs.open_spans == 0, "stream: open spans after the run")
    require(obs.metrics.counter_value("stream/rounds") == GENFV_STREAM["rounds"],
            "stream: the ledger did not reach Obs")
    return rounds


def stream_equals_sync(device, datasets):
    """D2: fault-free, quorum 1.0, 2 rounds at full width, under
    deterministic cuDNN: the stream's logs and parameters equal train()'s,
    bitwise."""
    run = RunConfig(**dict(GENFV_STREAM, rounds=2, faults=None))
    with deterministic_cudnn():
        sync_runner = GenFVRunner(run, device=device, dataset_fn=datasets)
        want = sync_runner.train().logs
        runner = GenFVRunner(run, device=device, dataset_fn=datasets)
        eng = StreamEngine(runner, StreamConfig(quorum=1.0))
        got = eng.run().logs
    require(got == want and torch.equal(_flat(runner.server.params),
                                        _flat(sync_runner.server.params)),
            "deterministic cuDNN: the full-quorum stream differs from train()")
    require(all(s.rung == 0 for s in eng.slogs), "stream == sync: a degraded rung")
    print(f"stream == sync (full width, fault-free, quorum 1.0, {run.rounds} rounds, "
          f"deterministic cuDNN): every RoundLog field and the parameters bitwise; "
          f"selected {[l.selected for l in got]}")


def stream_resume(device, datasets):
    """D3: the GENFV_STREAM run under deterministic cuDNN, saved after
    round 1 and resumed into a fresh engine: bitwise the uninterrupted
    run."""
    run, sc = RunConfig(**GENFV_STREAM), StreamConfig(**STREAM_POLICY)
    path = str(CKPT_DIR / "stream.npz")
    with deterministic_cudnn():
        full = StreamEngine(GenFVRunner(run, device=device, dataset_fn=datasets), sc)
        want = full.run(checkpoint_path=path, checkpoint_every=2).logs
        resumed = StreamEngine(GenFVRunner(run, device=device, dataset_fn=datasets), sc)
        t0 = time.perf_counter()
        nxt = resumed.load_checkpoint(path)
        load_ms = 1e3 * (time.perf_counter() - t0)
        n_inflight = len(resumed.inflight)
        require(nxt == 2 and all(x.device == device for e in resumed.inflight
                                 for x in tree_leaves(e.params)),
                f"stream resume: next round {nxt}, or in-flight updates off the card")
        got = resumed.run().logs
    size_mb = Path(path).stat().st_size / 1e6
    Path(path).unlink()
    require(got == want and resumed.slogs == full.slogs
            and torch.equal(_flat(resumed.runner.server.params), _flat(full.runner.server.params)),
            "deterministic cuDNN: the resumed stream differs from the uninterrupted one")
    print(f"stream resume (deterministic cuDNN): checkpoint after round 1 with {n_inflight} "
          f"in-flight updates, {size_mb:.1f} MB, load {load_ms:.2f} ms; round 2 from it: "
          f"every RoundLog and StreamLog field and the parameters bitwise")
    return {"checkpoint_mb": size_mb, "inflight_at_checkpoint": n_inflight, "load_ms": load_ms}


def stream_card_matches_cpu(device):
    """D4: STREAM_QUICK on the card and on the CPU, each round from the
    CPU's round-start parameters (the in-flight queues are each engine's
    own): StreamLog and the RoundLog integers equal, parameters within
    GENFV_PARAM_TOL."""
    cpu = torch.device("cpu")
    engines = {d: StreamEngine(GenFVRunner(RunConfig(**STREAM_QUICK),
                                           fl_cfg=GenFVConfig(**SMALL_FLEET), device=d),
                               StreamConfig(**STREAM_POLICY)) for d in (cpu, device)}
    worst = 0.0
    for t in range(STREAM_QUICK["rounds"]):
        engines[device].runner.server.params = tree_map(
            lambda x: x.to(device), engines[cpu].runner.server.params)
        logs = {d: e.run_round(t) for d, e in engines.items()}
        for f in LEDGER_INTS + ("t_bar", "t_round"):
            require(getattr(logs[cpu], f) == getattr(logs[device], f),
                    f"stream card vs CPU round {t}: {f} differs")
        require(vars(engines[cpu].slogs[-1]) == vars(engines[device].slogs[-1]),
                f"stream card vs CPU round {t}: StreamLog differs")
        d = float((_flat(engines[device].runner.server.params).cpu()
                   - _flat(engines[cpu].runner.server.params)).abs().max())
        require(d <= GENFV_PARAM_TOL, f"stream card vs CPU round {t}: params {d:.3e}")
        worst = max(worst, d)
    slogs = engines[device].slogs
    print(f"stream card == CPU (rush_hour + rush_hour_deep_fade, quick size, "
          f"{len(slogs)} rounds): StreamLog and RoundLog integers equal (rungs "
          f"{[s.rung for s in slogs]}, retries {sum(s.retries for s in slogs)}, merged "
          f"{sum(s.merged_inflight + s.gap_merged for s in slogs)}); params within {worst:.3e} "
          f"(tol {GENFV_PARAM_TOL})")
    return worst


def _same_plan(a, b):
    return (np.array_equal(a.alpha, b.alpha) and a.selected == b.selected
            and all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in ("l", "phi", "t_mu", "e_total"))
            and (a.b_gen, a.t_bar, a.t_rsu, a.bcd_iters, a.converged)
            == (b.b_gen, b.t_bar, b.t_rsu, b.bcd_iters, b.converged))


def _timed(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, 1e3 * (time.perf_counter() - t0)


def sweep_full_width(device):
    """D5: the five scenarios at full width through Sweep (2 rounds, cuDNN
    defaults), traced by Obs; every batched planner dispatch recorded and
    re-planned one fleet at a time (bitwise the same plans), and each
    round's fleets batched under one configuration against one by one;
    then Theorem 1's per-scenario table."""
    spec = ExperimentSpec(name="chip_sweep", scenarios=SWEEP_SCENARIOS,
                          base=RunConfig(**GENFV_SWEEP))
    calls = []

    def recording(cfg, fleets, model_bits, **kw):
        plans, ms = _timed(lambda: plan_rounds_batched(cfg, fleets, model_bits, **kw), device)
        calls.append((cfg, fleets, model_bits, kw, plans, ms))
        return plans
    obs = Obs(meta={"phase": "genfv_stream_sweep/sweep"})
    sweep_mod.plan_rounds_batched = recording
    try:
        result, total_ms = _timed(lambda: Sweep(spec, obs=obs, device=device).run(), device)
    finally:
        sweep_mod.plan_rounds_batched = plan_rounds_batched
    rounds = []
    for t in range(GENFV_SWEEP["rounds"]):
        ev = [e for e in obs.events if e["ph"] == "X" and e["tags"].get("round") == t]
        batched = [c for c, e in zip(calls, [e for e in obs.events
                                             if e["name"] == "sweep/plan_batched"])
                   if e["tags"]["round"] == t]
        single_ms = 0.0
        for cfg, fleets, model_bits, kw, plans, _ in batched:
            for i, fleet in enumerate(fleets):
                one, ms = _timed(lambda: plan_round(
                    cfg, fleet, model_bits, kw["batches"], b_prev=kw["b_prevs"][i],
                    svc=kw["svc"], alpha_override=kw["alpha_overrides"][i], planner="torch",
                    device=device), device)
                require(_same_plan(one, plans[i]),
                        f"sweep round {t}: a batched plan differs from the single one")
                single_ms += ms
        cfg0, _, model_bits0, kw0, _, _ = batched[0]
        fleets = [f for c in batched for f in c[1]]
        alphas = [a for c in batched for a in c[3]["alpha_overrides"]]
        b_prevs = [b for c in batched for b in c[3]["b_prevs"]]
        one_cfg, one_cfg_ms = _timed(lambda: plan_rounds_batched(
            cfg0, fleets, model_bits0, batches=kw0["batches"], b_prevs=b_prevs,
            alpha_overrides=alphas, device=device), device)
        one_by_one_ms = 0.0
        for i, fleet in enumerate(fleets):
            one, ms = _timed(lambda: plan_round(
                cfg0, fleet, model_bits0, kw0["batches"], b_prev=b_prevs[i],
                alpha_override=alphas[i], planner="torch", device=device), device)
            require(_same_plan(one, one_cfg[i]), f"sweep round {t}: one-config batch differs")
            one_by_one_ms += ms
        r = {"round": t, "lockstep_ms": 1e3 * (max(e["ts"] + e["dur"] for e in ev)
                                                - min(e["ts"] for e in ev)),
             "dispatches": len(batched), "batched_plan_ms": sum(c[5] for c in batched),
             "single_plan_ms": single_ms, "one_config_fleets": len(fleets),
             "one_config_batched_ms": one_cfg_ms, "one_config_single_ms": one_by_one_ms}
        rounds.append(r)
        print(f"sweep round {t}: {len(SWEEP_SCENARIOS)} cells in lockstep {r['lockstep_ms']:.2f} "
              f"ms; {r['dispatches']} planner dispatches (batches "
              f"{[len(c[1]) for c in batched]}) {r['batched_plan_ms']:.2f} ms, the same fleets "
              f"one by one {single_ms:.2f} ms, plans bitwise equal; the round's "
              f"{len(fleets)} fleets under one configuration: batched {one_cfg_ms:.2f} ms, one "
              f"by one {one_by_one_ms:.2f} ms")
    meta = result.meta
    require(list(result.rounds) == [GENFV_SWEEP["rounds"]] * len(SWEEP_SCENARIOS)
            and bool(np.isfinite(result.metrics["loss"]).all()),
            "sweep: a cell did not finish or its loss is not finite")
    require(meta["dataset_builds"] == 2 and meta["engines"] == 1,
            f"sweep: dataset builds {meta['dataset_builds']}, engines {meta['engines']}")
    report = theorem1_comparison(result)
    print(f"sweep (full width, {spec.n_cells} cells, {GENFV_SWEEP['rounds']} rounds): "
          f"{meta['planner_dispatches']} planner dispatches, largest batch "
          f"{meta['planner_largest_batch']}, {meta['dataset_builds']} dataset builds, "
          f"{meta['engines']} fleet engine; {total_ms:.2f} ms in all; final accuracy "
          f"{[round(float(x), 4) for x in result.final('accuracy')]}")
    print("Theorem 1 per scenario (sweep above):\n" + report.to_markdown())
    return {"rounds": rounds, "total_ms": total_ms, "meta": meta,
            "theorem1": report.per_scenario()}


def sweep_equals_cells(device):
    """D5, continued: a 2-cell, 2-round grid at width 0.25 under
    deterministic cuDNN: Sweep's metrics equal each cell run alone,
    bitwise, with one batched planner dispatch of 2 a round."""
    spec = ExperimentSpec(name="chip_hold", strategies=("genfv", "fedavg"),
                          base=RunConfig(**SWEEP_HOLD))
    with deterministic_cudnn():
        result = Sweep(spec, device=device).run()
        singles = [GenFVRunner(c.run, device=device).train() for c in spec.expand()]
    for c, single in zip(spec.expand(), singles):
        for key in ("loss", "accuracy", "t_bar", "selected", "b_gen", "kappa2", "bcd_iters"):
            require(np.array_equal(result.metrics[key][c.index], single.curve(key)),
                    f"deterministic cuDNN: sweep != cell {c.strategy} on {key}")
    require(result.meta["planner_dispatches"] == SWEEP_HOLD["rounds"]
            and result.meta["planner_largest_batch"] == 2,
            f"sweep hold: dispatches {result.meta['planner_dispatches']}")
    print(f"sweep == per cell (width {SWEEP_HOLD['width_mult']}, {spec.n_cells} cells, "
          f"{SWEEP_HOLD['rounds']} rounds, deterministic cuDNN): metrics bitwise, "
          f"{result.meta['planner_dispatches']} dispatches of 2")


def divergence_kept(device):
    """D6: a fault-free run whose vehicles diverge (CLIENT_LR 1e12) on both
    paths: no update rejected, the global non-finite on each."""
    kw = dict(rounds=1, train_size=400, test_size=64, strategy="fl_only", planner="numpy")
    saved = rounds_mod.CLIENT_LR
    rounds_mod.CLIENT_LR = 1e12
    try:
        logs = {}
        for vec in (True, False):
            r = GenFVRunner(RunConfig(vectorized=vec, **kw), fl_cfg=GenFVConfig(**SMALL_FLEET),
                            device=device)
            (log,) = r.train().logs
            finite = bool(torch.isfinite(_flat(r.server.params)).all())
            require(log.rejected == 0 and not finite,
                    f"divergence (vectorized={vec}): rejected {log.rejected}, finite {finite}")
            logs[vec] = log
    finally:
        rounds_mod.CLIENT_LR = saved
    require(all(getattr(logs[True], f) == getattr(logs[False], f) for f in LEDGER_INTS),
            "divergence: the two paths' ledgers differ")
    print(f"fault-free divergence (CLIENT_LR 1e12, both paths): rejected 0, global non-finite, "
          f"loss {logs[True].loss} / {logs[False].loss} (vectorized / sequential)")


def pretraining_pure(device):
    """D7: two pretrainings under the process's cuDNN flags, bitwise, and
    the flags as they were."""
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic, cudnn.benchmark
    ddpm = gen_service.runner_ddpm(10)
    kw = dict(steps=gen_service.PRETRAIN_STEPS, ref_size=gen_service.PRETRAIN_REF,
              seed=gen_service.PRETRAIN_SEED, device=device)
    (a, _), ms_a = _timed(lambda: pretrain_ddpm(ddpm, **kw), device)
    (b, _), ms_b = _timed(lambda: pretrain_ddpm(ddpm, **kw), device)
    d = _max_diff((a, b))
    require(d == 0.0, f"pretraining under the process's cuDNN flags: {d:.3e} apart")
    require((cudnn.deterministic, cudnn.benchmark) == before, "pretraining left cuDNN flags changed")
    print(f"pretraining under the process's cuDNN flags (deterministic, benchmark = {before}): "
          f"twice bitwise, {ms_a:.2f} and {ms_b:.2f} ms; flags the same after")
    return [ms_a, ms_b]


def genfv_stream_sweep(device):
    """Phase genfv_stream_sweep: D1-D7."""
    t_start = time.perf_counter()
    print(f"genfv_stream_sweep on {card()}")
    ops.flash_attention.launches = 0
    ops.rglru_scan.launches = 0
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    datasets = sweep_mod._DatasetCache()
    stream = stream_full_width(device, datasets)
    torch.cuda.empty_cache()
    stream_equals_sync(device, datasets)
    resume = stream_resume(device, datasets)
    del datasets
    torch.cuda.empty_cache()
    cpu_worst = stream_card_matches_cpu(device)
    sweep = sweep_full_width(device)
    torch.cuda.empty_cache()
    sweep_equals_cells(device)
    divergence_kept(device)
    pretrain_ms = pretraining_pure(device)
    require(ops.flash_attention.launches == 0 and ops.rglru_scan.launches == 0,
            "the streaming or sweep path launched a serving kernel")
    phase_s = time.perf_counter() - t_start
    print(f"genfv_stream_sweep: phase {phase_s:.1f} s; hand-written kernel launches 0")
    print(json.dumps({"genfv_stream_sweep": {
        "card": card(), "stream_rounds": stream, "resume": resume,
        "stream_card_vs_cpu_params_max_abs": cpu_worst, "sweep": sweep,
        "pretrain_ms": pretrain_ms, "phase_s": phase_s}}))


# ---------------------------------------------------------------------------
# Phase 7: timing
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
    genfv(device)
    torch.cuda.empty_cache()
    entries = time_kernels(device, errors, rec["launches"])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
