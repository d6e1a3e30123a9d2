#!/usr/bin/env python3
"""The paper's round count at full width on the GPU.

Runs `GenFVRunner(RunConfig(width_mult=1.0, train_size=50_000,
test_size=10_000, rounds=20))` with RunConfig's other defaults (strategy
genfv, scenario highway_free_flow, the oracle generator, planner "torch"):
the paper's ResNet-18 on CIFAR-10's sizes over the procedural dataset, for
the paper's 20 rounds. Prints the card's name and power limit, one line a
round (selected vehicles, b_gen, t_bar, loss, accuracy, round ms on a
device-synchronized host clock) and the rounds as JSON on the last line.

Run from the repository root on a machine with one NVIDIA GPU:
    python3 genfv_paper_rounds.py [--rounds 20]
Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.fl.rounds import GenFVRunner, RunConfig  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("genfv_paper_rounds: torch.cuda.is_available() is False")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    runner = GenFVRunner(RunConfig(width_mult=1.0, train_size=50_000, test_size=10_000,
                                   rounds=args.rounds), device=device)
    torch.cuda.synchronize(device)
    print(f"runner built in {time.perf_counter() - t0:.1f} s")
    rounds = []
    for t in range(args.rounds):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        log = runner.run_round(t)
        torch.cuda.synchronize(device)
        r = {"round": t, "selected": log.selected, "b_gen": log.b_gen, "t_bar": log.t_bar,
             "loss": log.loss, "accuracy": log.accuracy,
             "round_ms": 1e3 * (time.perf_counter() - t0)}
        rounds.append(r)
        print(f"round {t}: selected {r['selected']}, b_gen {r['b_gen']}, t_bar "
              f"{r['t_bar']:.4f} s, loss {r['loss']:.4f}, accuracy {r['accuracy']:.4f}, "
              f"{r['round_ms']:.2f} ms", flush=True)
    print(json.dumps({"card": card, "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
