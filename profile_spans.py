#!/usr/bin/env python3
"""Every span of a GenFV round over one benchmark cell's window, and the
planner's loop bodies.

Runs a cell of BENCHMARK.json as `port_bench/run.py --trace 1` does (the
seed's data and weights, the warm-up, a window of `--seconds` with the
device synchronized at both edges of every span and the traffic's rounds
profiled), without the output check, and prints one JSON line:

  timed_ms    the mean wall ms of the rounds outside the profiler; against
              an untraced run's round_ms, what the synchronized spans cost;
  spans       each span the program opened: [mean ms a round over the timed
              rounds that opened it, how many did];
  steps       the planner's loop bodies a round by part (RoundPlan.steps)
              and `syncs`, its host reads a round, over every round;
  busy_share, idle_gaps   of the profiled rounds, each gap named by the
              innermost span open across it.

Run from the repository root on a machine with one CUDA device:
    python3 profile_spans.py --workload cifar10.genfv-highway --seed 7 \\
        [--seconds 51] [--tree DIR]
`--tree DIR` runs the program of another checkout (DIR/src, say the parent
commit unpacked under build/) under this checkout's benchmark.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent


def spans_line(cell: dict, seed: int, seconds: float, device, t_start: float,
               log) -> dict:
    from port_bench.runcell import card_line, measure

    w = measure(cell, seed, seconds, True, device, t_start, log)
    rounds = w["rounds"]
    steps = {}
    for r in rounds:
        for part, n in getattr(r["plan"], "steps", {}).items():
            steps[part] = steps.get(part, 0) + n / len(rounds)
    timed = [r for r in rounds if not r["profiled"]]
    names = sorted({n for r in timed for n in r["ms"]})
    out = {"workload": cell["workload"]["name"], "seed": seed, "card": card_line(device),
           "rounds": len(rounds), "timed_ms": statistics.fmean(r["wall_ms"] for r in timed),
           "spans": {n: [statistics.fmean(r["ms"][n] for r in timed if n in r["ms"]),
                         sum(n in r["ms"] for r in timed)] for n in names},
           "steps": steps, "syncs": statistics.fmean(r["plan"].syncs for r in rounds)}
    prof = w["profile"]
    if prof:
        out["busy_share"] = prof["busy_s"] / prof["window_s"]
        out["idle_gaps"] = prof["idle_gaps"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--tree", default=None)
    args = p.parse_args(argv)

    os.environ["OMP_NUM_THREADS"] = "1"      # as port_bench/run.py
    tree = Path(args.tree).resolve() if args.tree else ROOT
    sys.path[:0] = [str(ROOT), str(tree / "src")]

    import torch

    from port_bench.spec import load_cell

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        log("profile_spans: needs a CUDA device")
        return 3
    out = spans_line(load_cell(args.workload), args.seed, args.seconds,
                     torch.device("cuda", 0), T_START, log)
    out["tree"] = str(tree)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
