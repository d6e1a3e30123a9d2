"""The benchmark's tracer for `GenFVRunner` (the `obs` it takes) and the
reduction of a profiler trace.

`Recorder` opens the runner's spans. With `timed` it synchronizes the device
at both edges of each span and records its wall milliseconds, so a span
holds the device work it launched (`chip_smoke.py` times its rounds with
it too). Without it a span costs a dict lookup. Either way a span's
entry can call a hook (the harness notes the random stream's state there),
and its exit can read what the program hands the span to wait on (`sync`:
omega_a for round/generate). While a profiler runs the spans' host
intervals are kept, to name what the host did in each idle gap of the
device.
"""
from __future__ import annotations

import time

import torch


class Recorder:
    enabled = False          # the runner feeds no metrics registry

    def __init__(self, device, timed: bool):
        self.device = device
        self.timed = timed
        self.hooks = {}      # span name -> fn(), called on entry
        self.exit_hooks = {}  # span name -> fn(span), called on exit
        self.ms = None       # span name -> [ms] of the current round
        self.intervals = None  # [(name, start, end)] of spans, on perf_counter

    def span(self, name, key=None, **tags):
        return _Span(self, name)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class _Span:
    __slots__ = ("rec", "name", "sync", "t0")

    def __init__(self, rec, name):
        self.rec, self.name, self.sync = rec, name, None

    def __enter__(self):
        rec = self.rec
        hook = rec.hooks.get(self.name)
        if hook is not None:
            hook()
        if rec.timed:
            rec.sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        if rec.timed:
            rec.sync()
        hook = rec.exit_hooks.get(self.name)
        if hook is not None:
            hook(self)
        t1 = time.perf_counter()
        if rec.ms is not None:
            rec.ms[self.name] = rec.ms.get(self.name, 0.0) + 1e3 * (t1 - self.t0)
        if rec.intervals is not None:
            rec.intervals.append((self.name, self.t0, t1))
        return False


def busy_ms(intervals, lo=float("-inf"), hi=float("inf")) -> float:
    """Union of (start, end) intervals in microseconds, clipped to [lo, hi],
    in ms (`profile_genfv.py`'s reduction)."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi)
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


def gaps(intervals, lo: float, hi: float):
    """The idle (start, end) intervals of [lo, hi] between the union of
    `intervals`, in microseconds."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def reduce_profile(prof, intervals, marker_host_s: float, top: int = 10) -> dict:
    """Device busy and window seconds, the top device operations and the
    longest idle gaps by the span the host was in, from a CUDA-only
    profiler run. `intervals` are the host's (name, start, end) of the
    profiled rounds ("round") and of their spans, on `time.perf_counter`;
    `marker_host_s` is when the host launched the marker kernel
    (`torch.cuda._sleep`) that ties the two clocks together."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
               if e.device_type == cuda]
    marks = [k for k in kernels if "spin_kernel" in k[2]]
    kernels = [k for k in kernels if "spin_kernel" not in k[2]]
    rounds = [(t0, t1) for name, t0, t1 in intervals if name == "round"]
    if not kernels or not marks or not rounds:
        return {}
    offset = min(m[0] for m in marks) - 1e6 * marker_host_s   # device us - host us
    lo = 1e6 * min(t0 for t0, _ in rounds) + offset
    hi = 1e6 * max(t1 for _, t1 in rounds) + offset
    ranges = [(1e6 * t0 + offset, 1e6 * t1 + offset, name)
              for name, t0, t1 in intervals if name != "round"]
    inside = [(s, e, n) for s, e, n in kernels if e > lo and s < hi]
    by_op = {}
    for s, e, name in inside:
        by_op[name] = by_op.get(name, 0.0) + (min(e, hi) - max(s, lo)) / 1e6
    by_gap = {}
    for s, e in gaps([(s, e) for s, e, _ in inside], lo, hi):
        mid = 0.5 * (s + e)
        inner = [r for r in ranges if r[0] <= mid < r[1]]
        name = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "between spans"
        by_gap[name] = by_gap.get(name, 0.0) + (e - s) / 1e6
    return {"busy_s": busy_ms([(s, e) for s, e, _ in inside], lo, hi) / 1e3,
            "window_s": (hi - lo) / 1e6,
            "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]}
