#!/usr/bin/env python3
"""What the dry-run's meta trace costs under `MetaTrace` and under plain
`torch.utils.flop_counter.FlopCounterMode`.

Traces the step of one dry-run pair (qwen1.5-0.5b x train_4k at full
width, bf16, on the meta device: the plain route with remat and AdamW, as
`launch.dryrun` traces it) under each mode in turns (MetaTrace,
FlopCounterMode, FlopCounterMode, MetaTrace), each from fresh argument
specs, and prints each trace's host seconds, the ops dispatched (counted
by MetaTrace), the time an op, and whether both modes count the same
FLOPs by op. The card is not used; the numbers are host time, so the
script prints the machine's card beside them and is run where
`chip_smoke.py` runs:
    python3 profile_metatrace.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.metatrace import MetaTrace  # noqa: E402
from repro_torch.optim import adamw, constant_schedule  # noqa: E402

ARCH, SHAPE = "qwen1.5-0.5b", "train_4k"
TURNS = ("metatrace", "flop_counter", "flop_counter", "metatrace")


def trace(mode: str):
    """(seconds, FLOPs by op, ops or None) of one trace under `mode`."""
    cfg, shape = get_config(ARCH), INPUT_SHAPES[SHAPE]
    opt = adamw(constant_schedule(1e-4))
    args, _ = S.input_specs(cfg, shape, opt, dtype=torch.bfloat16)
    step = dryrun.build_step(cfg, shape, opt, impl="torch")
    t0 = time.perf_counter()
    if mode == "metatrace":
        with MetaTrace() as mt:
            step(*args)
        seconds = time.perf_counter() - t0
        return seconds, {str(k): v for k, v in mt.flops.items()}, mt.calls
    with FlopCounterMode(display=False) as fc:
        step(*args)
    seconds = time.perf_counter() - t0
    return seconds, {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}, None


def main():
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        card = "no card"
    print(card)
    torch.set_num_threads(1)
    runs, flops, ops = [], {}, None
    for mode in TURNS:
        seconds, by_op, calls = trace(mode)
        ops = calls if calls is not None else ops
        flops.setdefault(mode, by_op)
        runs.append({"mode": mode, "s": seconds})
        print(f"{ARCH} x {SHAPE} under {mode}: {seconds:.3f} s", flush=True)
    same = flops["metatrace"] == flops["flop_counter"]
    if not same:
        raise SystemExit("MetaTrace and FlopCounterMode counted different FLOPs")
    per = {m: [r["s"] for r in runs if r["mode"] == m] for m in ("metatrace", "flop_counter")}
    print(json.dumps({"pair": f"{ARCH} x {SHAPE}", "card": card, "ops": ops,
                      "runs": runs, "flops_equal": same,
                      "us_per_op": {m: [1e6 * s / ops for s in v] for m, v in per.items()},
                      "flop_counter_over_metatrace": min(per["flop_counter"])
                      / min(per["metatrace"])}))


if __name__ == "__main__":
    main()
