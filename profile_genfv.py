#!/usr/bin/env python3
"""Where one GenFV round's time goes on the GPU.

Builds chip_smoke.py's full-width run (the paper's ResNet-18 on CIFAR-10's
sizes, RunConfig's defaults otherwise), runs round 0 to pay the first
calls into cuDNN and cuBLAS, then:

  1. times one K=5 fleet step at bucket 8 with cuDNN's default algorithms
     and with `torch.backends.cudnn.deterministic`, in turns (A B B A ...),
     CUDA-synchronized host clock, 4 runs each;
  2. traces round 1 with torch.profiler. The runner's spans become
     profiler ranges, fenced with a device sync at both edges, so a
     stage's kernels run inside its range. Per stage: wall ms, device busy
     ms (union of its kernels' intervals) and kernels; over the round the
     same and the idle share; then the kernels ranked by device time;
  3. plans the fleets of rounds 0-2 again with the port's planner as it
     is (one water-filling step per budget projection, the chunk redone
     with all Kp steps when a lane needed more), with a variant that runs
     all Kp projection steps in every bandwidth iteration, and with the
     numpy planner: ms per plan (in turns, 3 runs each), device kernels
     per plan (one traced run each) and whether the plans are equal.

Run from the repository root on a machine with one NVIDIA GPU:
    python3 profile_genfv.py
Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.emd import data_weights  # noqa: E402
from repro_torch.core.two_scale import plan_round  # noqa: E402
from repro_torch.fl.rounds import GenFVRunner, RunConfig  # noqa: E402
from repro_torch.obs import NULL_OBS  # noqa: E402

STAGES = ("round/fleet", "round/select", "round/plan", "round/generate",
          "round/local_sgd", "round/aggregate", "round/world_step", "round/eval")


class ProfiledObs:
    """The runner's spans as profiler ranges, synchronized at both edges."""
    enabled = False

    def __init__(self, device):
        self.device = device

    def span(self, name, key=None, **tags):
        return _Range(name, self.device)


class _Range:
    def __init__(self, name, device):
        self.rf, self.device, self.sync = record_function(name), device, None

    def __enter__(self):
        chip_smoke.sync(self.device)
        self.rf.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        chip_smoke.sync(self.device)
        return self.rf.__exit__(exc_type, exc, tb)


def fleet_step_ab(runner, device, runs=4):
    eng = runner.engine
    rng = np.random.default_rng(0)
    parts = [i for i, (_, y) in enumerate(runner.client_data) if len(y) >= 2][:5]
    bis, bls = zip(*[eng.sample_batches(rng, *runner.client_data[i]) for i in parts])
    rhos = data_weights([runner.sizes[i] for i in parts])
    g = runner.server.params

    def once(det):
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = det
        try:
            chip_smoke.sync(device)
            t0 = time.perf_counter()
            eng.run(g, list(bis), list(bls), rhos, 1.0, g, bucket=8, guard=False)
            chip_smoke.sync(device)
            return 1e3 * (time.perf_counter() - t0)
        finally:
            torch.backends.cudnn.deterministic = prev

    once(False)
    once(True)
    ms = {False: [], True: []}
    for det in [False, True, True, False] * (runs // 2):
        ms[det].append(once(det))
    print(f"fleet step K=5 bucket 8: default cuDNN {[round(x, 1) for x in ms[False]]} ms "
          f"(median {statistics.median(ms[False]):.1f}), deterministic "
          f"{[round(x, 1) for x in ms[True]]} ms (median {statistics.median(ms[True]):.1f})")


def busy_ms(events, lo=float("-inf"), hi=float("inf")):
    """Union of the events' intervals, clipped to [lo, hi], in ms."""
    spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                   for e in events if e.time_range.end > lo and e.time_range.start < hi)
    total, start, end = 0.0, None, None
    for s, e in spans:
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total / 1e3


def profile_round(runner, device, t):
    runner.obs = ProfiledObs(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chip_smoke.sync(device)
        t0 = time.perf_counter()
        pending = runner.begin_round(t)
        plan = runner.plan(pending)
        log = runner.finish_round(pending, plan)
        chip_smoke.sync(device)
        wall = 1e3 * (time.perf_counter() - t0)
    runner.obs = NULL_OBS
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    kernels = [e for e in events if e.device_type == cuda and e.name not in STAGES]
    busy = busy_ms(kernels)
    print(f"round {t} under the profiler: wall {wall:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / wall:.3f}, {len(kernels)} kernels; selected "
          f"{log.selected}, bucket {chip_smoke.bucket_size(log.selected)}, planner syncs "
          f"{plan.syncs}")
    for name in STAGES:
        ranges = [e for e in events if e.device_type != cuda and e.name == name]
        for r in ranges:
            lo, hi = r.time_range.start, r.time_range.end
            n = sum(1 for k in kernels if lo <= k.time_range.start < hi)
            print(f"  {name}: wall {(hi - lo) / 1e3:.2f} ms, device busy "
                  f"{busy_ms(kernels, lo, hi):.2f} ms, {n} kernels")
    ranked = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0
                     and not e.key.startswith(("aten::", "round/", "autograd::"))),
                    key=lambda e: -e.self_device_time_total)
    print("kernels by device time:")
    for e in ranked[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d} calls  {e.key[:90]}")
    return pending


def _solve_bandwidth_all_steps(c, B, D, t_cp, e_cp, valid, n_val, done, read):
    """planner._solve_bandwidth without the one-step projection and its
    redo: every bandwidth iteration runs all Kp projection steps."""
    l0 = torch.where(valid, c.M / n_val[:, None], 0.0)
    ones = torch.ones_like(n_val)
    st = (torch.ones_like(l0), ones, ones, l0, l0,
          torch.zeros_like(n_val, dtype=torch.int64), done)
    while True:
        for _ in range(planner.SYNC_EVERY):
            st, _ = planner._bandwidth_step(c, st, B, D, t_cp, e_cp, valid, n_val,
                                            valid.shape[-1])
        if read(st[6].all()):
            return st[3]


def planner_ab(runner, fleets, device, runs=3):
    port_solver = planner._solve_bandwidth
    variants = {"one-step + redo": port_solver, "all Kp steps": _solve_bandwidth_all_steps}

    def plan(pending, b_prev, name):
        planner._solve_bandwidth = variants.get(name, port_solver)
        try:
            chip_smoke.sync(device)
            t0 = time.perf_counter()
            p = plan_round(runner.cfg, pending.fleet, runner.model_bits,
                           runner.cfg.local_steps, b_prev=b_prev, alpha_override=pending.alpha,
                           planner="numpy" if name == "numpy" else "torch", device=device)
            chip_smoke.sync(device)
            return p, 1e3 * (time.perf_counter() - t0)
        finally:
            planner._solve_bandwidth = port_solver

    cuda = torch.autograd.DeviceType.CUDA
    names = list(variants) + ["numpy"]
    for t, (pending, b_prev) in enumerate(fleets):
        plans = {n: plan(pending, b_prev, n)[0] for n in names}
        ms = {n: [] for n in names}
        for name in (names + names[::-1]) * ((runs + 1) // 2):
            if len(ms[name]) < runs:
                ms[name].append(plan(pending, b_prev, name)[1])
        kernels = {}
        for name in variants:
            with profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                                     else ProfilerActivity.CPU]) as prof:
                plan(pending, b_prev, name)
            kernels[name] = sum(1 for e in prof.events() if e.device_type == cuda)
        a, b = (plans[n] for n in variants)
        same = (np.array_equal(a.l, b.l) and np.array_equal(a.phi, b.phi)
                and a.t_bar == b.t_bar and a.b_gen == b.b_gen and a.bcd_iters == b.bcd_iters)
        print(f"planner round {t} (K {len(a.selected)}, bucket "
              f"{chip_smoke.bucket_size(len(a.selected))}, bcd_iters {a.bcd_iters}): "
              + "; ".join(f"{n}: {[round(x, 2) for x in ms[n]]} ms (median "
                          f"{statistics.median(ms[n]):.2f})"
                          + (f", {plans[n].syncs} syncs, {kernels[n]} kernels"
                             if n in kernels else "") for n in names)
              + f"; one-step + redo == all Kp steps bitwise: {same}")
        chip_smoke.require(same, f"planner round {t}: the redo path changed the plan")


def main():
    chip_smoke.check_device()
    device = torch.device("cuda", torch.cuda.current_device())
    runner = GenFVRunner(RunConfig(**chip_smoke.GENFV_FULL), device=device)
    fleets = []

    def keep(t):
        pending, b_prev = runner.begin_round(t), runner.b_prev
        runner.finish_round(pending, runner.plan(pending))
        fleets.append((pending, b_prev))

    keep(0)
    fleet_step_ab(runner, device)
    b_prev = runner.b_prev
    fleets.append((profile_round(runner, device, 1), b_prev))
    keep(2)
    planner_ab(runner, fleets, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
