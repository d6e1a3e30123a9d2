#!/usr/bin/env python3
"""Readings that the output check's limits are set from, on one device.

    python3 port_bench/control.py --workload <cell> --seeds 11,12,13 --seconds 20

For each seed: one run of the cell's window, then, over the rounds the
check samples, the three numbers of

* the program against the reference (the lower readings);
* the control against the reference: the reference in the program's place,
  its model in TF32 (the precision below the configuration's float32 with
  TF32 off) and its planner in float32 (below float64);
* planted faults against the reference: each SGD step on half its batch
  (half_batch), omega_a's steps alone on half their batch
  (aug_half_batch), the round's parameters left as they started
  (unchanged), one test image more counted correct (eval_plus_one), b_gen
  one more (b_gen_plus_one).

Where the cell's limits name gen_gap, also the generated images of every
round up to the last sampled one ("gens"): the program's, the control's
(the generator reference in TF32) and, in the sampled rounds, those of the
generator reference's planted faults (its FAULTS: for the DDPM a denoising
step left out, labels moved by one class, another image's noise), each as
gen_gap against the reference; a fault's numbers in a sampled round are
the program's with its gen_gap.

One JSON line a seed on standard output. The benchmark's runs do not run
this; `test_bench_faults.py` runs it at a small size on the CPU and
`test_bench_card.py` at the cell's own size on a CUDA device.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def readings(cell: dict, seed: int, seconds: float, device, log=print) -> dict:
    import numpy as np

    from port_bench import check as chk
    from port_bench.reference.model import Precision
    from port_bench.reference.round import plan_only
    from port_bench.reference.model import FP32
    from port_bench.runcell import measure
    from port_bench.spec import reference_cell

    w = measure(cell, seed, seconds, False, device, time.perf_counter(), log)
    rounds = w["rounds"]
    ref = chk.Reference(reference_cell(cell), w["train"], w["test"],
                        cell["traffic"]["world_seed"], device, seed)
    tf32 = Precision(tf32=True)
    n_test = len(ref.test_y)
    out = {"seed": seed, "setup_s": w["setup_s"], "rounds": len(rounds),
           "round_ms": 1e3 * w["window_s"] / len(rounds), "picked": {}, "plans": {},
           "evals": {}, "gens": {}}
    last = max(w["picked"], default=-1) if "gen_gap" in cell["limits"] else -1
    for i in range(last + 1):
        want = ref.images(rounds, i)[0]
        out["gens"][i] = {"program": chk.gen_gap(rounds[i].get("gen"), want),
                          "control": chk.gen_gap(ref.images(rounds, i, tf32)[0], want)}
        if i in w["picked"]:
            out["gens"][i].update({f: chk.gen_gap(ref.images(rounds, i, FP32, f)[0], want)
                                   for f in ref.gen.FAULTS})
    for i, r in enumerate(rounds):
        # every round: the plan (program, float32 control) and the count of
        # test images right (program; the control's TF32 forward pass)
        plan = ref.plan(rounds, i)
        band = ref.correct(r["p1"])
        out["plans"][i] = [chk.plan_gap(chk.program_output(r, n_test)["plan"], plan),
                           chk.plan_gap(plan_only(ref.cell, chk.round_state(r), ref.data,
                                                  np.float32), plan)]
        out["evals"][i] = [chk.count_gap(chk.program_output(r, n_test)["correct"], band),
                           chk.count_gap(ref.correct(r["p1"], tf32)[2], band)]
    for i in w["picked"]:
        r = rounds[i]
        p0 = r["p0"]
        t0 = time.perf_counter()
        base = ref.round(rounds, i)
        n_ref = ref.correct(r["p1"])
        t_ref = time.perf_counter() - t0
        prog = chk.program_output(r, n_test)

        ctl = ref.round(rounds, i, prec=tf32, ft=np.float32)
        as_prog = {"plan": ctl["plan"], "loss": ctl["loss"], "p1": ctl["new"],
                   "aug": ctl["aug"], "aug_loss": ctl["aug_loss"],
                   "correct": ref.correct(ctl["new"], tf32)[2]}
        control = chk.numbers(as_prog, base, p0, ref.correct(ctl["new"]))

        def planted(half_batch):
            half = ref.round(rounds, i, half_batch=half_batch)
            band = ref.correct(half["new"])
            as_half = {"plan": half["plan"], "loss": half["loss"], "p1": half["new"],
                       "aug": half["aug"], "aug_loss": half["aug_loss"], "correct": band[2]}
            nums = chk.numbers(as_half, base, p0, band)
            if i in out["gens"]:     # the reference's own images
                nums["gen_gap"] = 0.0
            return nums

        program = chk.numbers(prog, base, p0, n_ref)
        if i in out["gens"]:
            control["gen_gap"] = out["gens"][i]["control"]
            program["gen_gap"] = out["gens"][i]["program"]
        faults = {"half_batch": planted(("aug", "vehicles")),
                  "unchanged": chk.numbers(dict(prog, p1=p0, aug=p0 if prog["aug"] is not None
                                                else None), base, p0, n_ref),
                  "eval_plus_one": chk.numbers(dict(prog, correct=prog["correct"] + 1),
                                               base, p0, n_ref)["eval_gap"],
                  "b_gen_plus_one": chk.plan_gap(dict(prog["plan"], b_gen=prog["plan"]["b_gen"] + 1),
                                                 base["plan"])}
        if cell["traffic"]["strategy"] == "genfv":
            faults["aug_half_batch"] = planted(("aug",))
        if i in out["gens"]:
            faults["unchanged"]["gen_gap"] = program["gen_gap"]
            faults.update({f: dict(program, gen_gap=out["gens"][i][f]) for f in ref.gen.FAULTS})
        out["picked"][i] = {
            "selected": r["log"].selected, "reference_s": t_ref, "kappa2": base["kappa"][1],
            "pool": r["pool_n"],
            "program": program,
            "control": control,
            "faults": faults,
        }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    torch.set_num_threads(1)

    from port_bench.spec import load_cell
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.seconds, torch.device("cuda", 0),
                                  lambda m: print(m, file=sys.stderr, flush=True))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
