#!/usr/bin/env python3
"""Hold chip_smoke.py's bf16 flash-attention limits against the kernel and
against copies of it broken on purpose.

For the kernel as it is, and for each edit in MUTATIONS, this builds the
kernels (a mutation in a temporary copy of the tree) and runs every bf16
case of chip_smoke.py's phase 3: its named cases (the test cases, masked
rows, decode splits and empty lanes, prefills with mixed blocks) and the
serving shapes. Per case it prints the worst share of the elementwise
limit (chip_smoke.flash_limit), the rms share against
chip_smoke.FLASH_RMS_TOL, and whether the earlier limit 2e-2 x max(1,
|plain|) would pass. The kernel as it is must pass every case and each
mutation must fail one, else the exit code is 1.

Run from the repository root on a CUDA machine:  python3 check_flash_limits.py
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
PARALLEL = 4
# (text that appears once in the source, replacement)
MUTATIONS = {
    # the wgmma prefill path skips P.V for one kv tile
    "drop_tile": [("for (int kstep = 0; kstep < kPfKeys / 16; ++kstep) {",
                   "for (int kstep = 0; kstep < (i == n_live / 2 ? 0 : kPfKeys / 16); ++kstep) {")],
    # every path lets the key at distance `window` in
    "window_edge": [("if (window > 0) valid = valid && rel < window;",
                     "if (window > 0) valid = valid && rel <= window;")],
    # the wgmma prefill path's softmax sum is 2% high
    "softmax_sum": [("row_sum0 = row_sum0 * alpha0 + tile_sum0;",
                     "row_sum0 = row_sum0 * alpha0 + tile_sum0 * 1.02f;"),
                    ("row_sum1 = row_sum1 * alpha1 + tile_sum1;",
                     "row_sum1 = row_sum1 * alpha1 + tile_sum1 * 1.02f;")],
    # the decode combine leaves out one split's partial
    "drop_split": [("for (int sp = 0; sp < n_splits; ++sp) {",
                    "for (int sp = 0; sp < n_splits; ++sp) {\n    if (sp == n_splits / 2) continue;")],
    # the prefill's tile test skips tiles that hold a valid pair (those
    # reaching past the block's last query position)
    "skip_live_tile": [("live = live && (long long)lo <= qmax;",
                        "live = live && (long long)hi <= qmax;")],
    # the same in the hd-64 prefill's tile classes
    "skip_live_tile64": [("live = live && qmax >= lo;", "live = live && qmax >= hi;")],
    # the hd-64 prefill: P.V skipped for one kv tile
    "drop_tile64": [("for (int kstep = 0; kstep < NK / 16; ++kstep)",
                     "for (int kstep = 0; kstep < (i == n_live / 2 ? 0 : NK / 16); ++kstep)")],
    # the hd-64 prefill's softmax sum is 2% high
    "softmax_sum64": [("row_sum0 = fmaf(row_sum0, alpha0, tile_sum0);",
                       "row_sum0 = fmaf(row_sum0, alpha0, tile_sum0 * 1.02f);"),
                      ("row_sum1 = fmaf(row_sum1, alpha1, tile_sum1);",
                       "row_sum1 = fmaf(row_sum1, alpha1, tile_sum1 * 1.02f);")],
    # the hd-64 prefill calls a block's diagonal tile full (so never masks it)
    "full_diagonal64": [("full = full && qmin >= hi;", "full = full && qmin >= lo;")],
    # the hd-64 prefill's partial tiles read stale positions (never staged)
    "stale_positions64": [("if (e & 1) {", "if (false) {")],
    # the decode ring refills one subtile too far ahead: a warp skips keys
    "decode_ring_gap": [("const int ahead = t0 + (ST - 1) * STEP;",
                         "const int ahead = t0 + ST * STEP;")],
}


def bf16_cases(cs, gen, dev):
    import torch
    cases = [(f"serving {kind}",) + cs.slice_attention_inputs(kind, gen, dev)
             for kind in ("decode", "prefill")]
    return cases + cs.attention_cases(gen, dev, torch.bfloat16)


def evaluate(label):
    """Run in the tree to check (the current directory); prints one line per
    case and, last, {"label", "failed", "cases"}."""
    sys.path.insert(0, str(Path.cwd()))
    import torch
    import chip_smoke as cs
    cs.build.load()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = 0
    cases = bf16_cases(cs, gen, dev)
    for name, args, kw in cases:
        got = cs.ops.flash_attention(*args, **kw).float()
        want = cs.flash_attention_ref(*args, **kw).float()
        diff = (got - want).abs()
        old = float((diff / want.abs().clamp(min=1.0)).max())
        worst = float((diff / cs.flash_limit(args, kw, want)).max())
        rms = float(diff.square().mean().sqrt() / want.square().mean().sqrt())
        fails = worst > 1.0 or rms > cs.FLASH_RMS_TOL[torch.bfloat16]
        failed += fails
        print(f"{label} | {name}: max abs {float(diff.max()):.3e}, elementwise {worst:.3f} "
              f"x the limit, rms {rms:.3e}, earlier limit "
              f"{'fails' if old > 2e-2 else 'passes'} ({old:.3e}) | "
              f"{'FAILS' if fails else 'passes'}")
    print(json.dumps({"label": label, "failed": failed, "cases": len(cases)}))


def run(label, tree):
    res = subprocess.run([sys.executable, "check_flash_limits.py", "--evaluate", label],
                         cwd=tree, capture_output=True, text=True, timeout=900)
    print(res.stdout + (res.stderr if res.returncode else ""), end="", flush=True)
    if res.returncode:
        raise RuntimeError(f"{label}: exit {res.returncode}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def mutate(tree, edits):
    path = tree / SOURCE
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} is not once in {SOURCE}")
        text = text.replace(old, new)
    path.write_text(text)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--evaluate":
        evaluate(sys.argv[2])
        return 0
    from concurrent.futures import ThreadPoolExecutor
    import chip_smoke as cs
    cs.check_device()
    ok = run("none", ROOT)["failed"] == 0
    with tempfile.TemporaryDirectory() as tmp:
        trees = {}
        for label, edits in MUTATIONS.items():
            tree = trees[label] = Path(tmp) / label
            shutil.copytree(ROOT / "src", tree / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            for script in ("chip_smoke.py", "check_flash_limits.py"):
                shutil.copy(ROOT / script, tree / script)
            mutate(tree, edits)
        # the copies build and run PARALLEL at a time on the one card
        with ThreadPoolExecutor(PARALLEL) as pool:
            results = list(pool.map(lambda kv: run(*kv), trees.items()))
    ok &= all(r["failed"] > 0 for r in results)
    print(f"bf16 flash limits: {'hold' if ok else 'DO NOT hold'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
