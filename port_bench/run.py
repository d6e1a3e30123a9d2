#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. Prints progress and, as its last lines, the numbers of the output
check on standard error, and one JSON line on standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` `breakdown`, and last `check`. Exits non-zero, printing no
result, without enough CUDA devices, without the program, or where JAX or
the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # one intra-op thread: the load comes from this one process, and idle
    # OpenMP workers spinning beside the host-bound round loop made runs of
    # one cell spread several times wider
    os.environ["OMP_NUM_THREADS"] = "1"
    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / "build" / "port_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import json

    import torch

    from port_bench.runcell import ForbiddenModules, run_cell
    from port_bench.spec import load_cell

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    torch.set_num_threads(1)
    cell = load_cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"port_bench: the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() {torch.cuda.is_available()}, "
            f"device_count {torch.cuda.device_count()}")
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        log(f"port_bench: the program (src/repro_torch) is not here: {e}")
        return 4
    try:
        result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                 torch.device("cuda", 0), T_START, log)
    except ForbiddenModules as e:
        log(f"port_bench: loaded in this process: {e}")
        return 5
    print(json.dumps(result), flush=True)
    for line in lines:
        log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
