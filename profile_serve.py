#!/usr/bin/env python3
"""Where a serving step of the PyTorch port spends its time on the GPU.

Fills the four slots of chip_smoke.py's engine (recurrentgemma-9b at full
width in bf16, random weights from seed 0; or, with `--arch gemma2-9b`,
the `families` phase's gemma2-9b engine with 8192-slot caches) with the
first four prompts of its serving mix, then times one warm prefill of
each prompt length of the mix (CUDA-synchronized host clock, the second
of two runs), and traces one prefill of the mix's second prompt length
(2048 tokens; 4096 for gemma2-9b) and a window of decode ticks with
torch.profiler, through the model API's prefill and decode steps. For
each it prints the wall time, the time the host takes to enqueue the
step, the device-busy time (the union of kernel intervals on the
device), the idle share, the kernels ranked by device time, and each of
the port's own kernels with its share of the device-busy time.

Run from the repository root on a CUDA machine:
    python3 profile_serve.py [--arch recurrentgemma-9b|gemma2-9b]
"""
from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

# chip_smoke puts src/ on sys.path, so it is imported first
from chip_smoke import (ARCH, FAMILY_ARCH, FAMILY_MAX_LEN, FAMILY_MIX, SERVE_MIX,
                        check_device, make_engine, make_requests)
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.models import api

TICKS = 8
# Name fragments of the port's own kernels (src/repro_torch/kernels/csrc).
PORT_KERNELS = ("flash_", "prefill_prep_kernel", "chunk_summary", "chunk_carry", "chunk_scan")


def device_events(prof):
    """(name, start_us, duration_us) of every kernel the trace saw."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0:
            out.append((e.name, e.time_range.start, e.time_range.elapsed_us()))
    return out


def busy_us(events):
    """Length of the union of the kernel intervals."""
    total, end = 0.0, float("-inf")
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        stop = start + dur
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def report(label, prof, wall_ms, enqueue_ms, steps):
    events = device_events(prof)
    busy = busy_us(events) / 1e3
    print(f"{label}: {steps} step(s), wall {wall_ms / steps:.2f} ms per step, host enqueue "
          f"{enqueue_ms / steps:.2f} ms per step, device busy {busy / steps:.2f} ms per step, "
          f"idle share {1 - busy / wall_ms:.3f}, {len(events) / steps:.0f} kernels per step")
    by_name = defaultdict(lambda: [0, 0.0])
    for name, _, dur in events:
        by_name[name][0] += 1
        by_name[name][1] += dur
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (n, dur) in ranked[:14]:
        print(f"  {dur / 1e3 / steps:8.3f} ms/step {n / steps:7.1f} calls/step  {name[:110]}")
    print("  the port's kernels, share of device-busy time:")
    for name, (n, dur) in ranked:
        if any(k in name for k in PORT_KERNELS):
            short = name.replace("void ", "").replace("(anonymous namespace)::", "")
            print(f"  {dur / 1e3 / steps:8.3f} ms/step {n / steps:7.1f} calls/step "
                  f"{dur / 1e3 / busy:6.1%}  {short.split('(')[0][:80]}")
    cumsum = sum(dur for name, (n, dur) in ranked
                 if ("cumsum" in name.lower() or "scan" in name.lower())
                 and not any(k in name for k in PORT_KERNELS))
    print(f"  cumsum and other library scans: {cumsum / 1e3 / steps:.3f} ms/step")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=ARCH, choices=(ARCH, FAMILY_ARCH))
    args = ap.parse_args()
    mix, max_len = (SERVE_MIX, 4096) if args.arch == ARCH else (FAMILY_MIX, FAMILY_MAX_LEN)
    check_device()
    build.load()
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(args.arch)
    eng, _ = make_engine(cfg, torch.bfloat16, device, slots=4, max_len=max_len)
    for r in make_requests(cfg, [(p, 10_000) for p, _ in mix[:4]]):
        eng.submit(r)
    for _ in range(3):                      # admit all four, warm up decode
        eng.step()
    prefill, decode = api.make_prefill_step(cfg), api.make_decode_step(cfg)

    rng = np.random.default_rng(1)
    warm = []
    for n, _ in mix:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, n)), device=device)
        for _ in range(2):
            lane = api.init_cache(cfg, 1, max_len, torch.bfloat16, device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(eng.params, lane, {"tokens": toks})
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        warm.append(f"{ms:.1f} ({n})")
        del lane
    print(f"{args.arch} warm prefill ms (prompt length), second of two runs: " + ", ".join(warm))

    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, mix[1][0])), device=device)
    for traced in (False, True):            # the first prefill warms up
        lane = api.init_cache(cfg, 1, max_len, torch.bfloat16, device)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill(eng.params, lane, {"tokens": prompt})
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
    report(f"prefill {mix[1][0]} tokens", prof, 1e3 * (t2 - t0), 1e3 * (t1 - t0), 1)

    toks = torch.as_tensor(eng.last_tok, device=device)[:, None]
    pos = torch.as_tensor(eng.positions, dtype=torch.int32, device=device)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cache = eng.cache
        for _ in range(TICKS):
            logits, cache = decode(eng.params, cache, toks, pos)
            pos = pos + 1
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    report("decode tick, 4 slots", prof, 1e3 * (t2 - t0), 1e3 * (t1 - t0), TICKS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
