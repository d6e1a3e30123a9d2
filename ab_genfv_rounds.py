#!/usr/bin/env python3
"""Phase 6 of chip_smoke.py from two trees of this repository, in turns on
one card.

Phase 6 runs three full-width GenFV rounds and times each stage with the
device synchronised at its edges (`chip_smoke.genfv_full_width`). This
script runs it once a turn, each turn in a fresh process that imports its
own tree's `chip_smoke` and `repro_torch`: by default the other tree, this
tree, this tree, the other tree (A, B, B, A). Both trees are so timed by
the same code on the same card in one run, and a difference between them
can be told from the spread between turns.

    python3 ab_genfv_rounds.py OTHER_TREE [ORDER]

ORDER is a string of A (the other tree) and B (this tree), one letter a
turn, default ABBA; each tree needs at least one turn.

OTHER_TREE is a copy of another commit, for example the parent unpacked
with `git archive` into build/ (which git ignores). Prints the card's name
and power limit, each turn's stage ms per round, and per round and stage
the two trees' turns side by side with their medians, and last all turns
as one JSON object. Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STAGES = ("plan_ms", "generate_ms", "fleet_step_ms", "eval_ms", "round_ms")
CHILD = ("import sys, torch; sys.path.insert(0, sys.argv[1]); import chip_smoke as cs; "
         "cs.check_device(); "
         "cs.genfv_full_width(torch.device('cuda', torch.cuda.current_device()))")


def run_turn(tree: Path):
    out = subprocess.run([sys.executable, "-c", CHILD, str(tree)], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"ab_genfv_rounds: the turn in {tree} exited {out.returncode}")
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith('{"genfv_rounds"')]
    if not lines:
        raise SystemExit(f"ab_genfv_rounds: the turn in {tree} printed no rounds")
    return json.loads(lines[-1])["genfv_rounds"]


def main() -> int:
    if len(sys.argv) not in (2, 3):
        raise SystemExit(__doc__)
    order = sys.argv[2] if len(sys.argv) == 3 else "ABBA"
    if set(order) != {"A", "B"}:
        raise SystemExit(f"ab_genfv_rounds: ORDER {order!r} needs turns of A and of B, and "
                         "no other letter")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_genfv_rounds: torch.cuda.is_available() is False")
    other = Path(sys.argv[1]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    trees = {"other": other, "this": ROOT}
    turns = []
    for name in ({"A": "other", "B": "this"}[c] for c in order):
        rounds = run_turn(trees[name])
        turns.append({"tree": name, "path": str(trees[name]), "rounds": rounds})
        print(f"turn {len(turns)} ({name}, {trees[name]}): " + "; ".join(
            f"round {r['round']} " + ", ".join(f"{s[:-3]} {r[s]:.2f}" for s in STAGES)
            for r in rounds))
    print("ms per stage, the other tree's turns (median) | this tree's turns (median):")
    for t in range(len(turns[0]["rounds"])):
        cells = []
        for s in STAGES:
            side = []
            for tree in ("other", "this"):
                ms = [turn["rounds"][t][s] for turn in turns if turn["tree"] == tree]
                side.append("/".join(f"{x:.2f}" for x in ms)
                            + f" ({statistics.median(ms):.2f})")
            cells.append(f"{s[:-3]} {side[0]} | {side[1]}")
        print(f"  round {t}: " + "; ".join(cells))
    print(json.dumps({"device": smi.stdout.strip(), "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
