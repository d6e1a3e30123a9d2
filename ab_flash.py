#!/usr/bin/env python3
"""Time the flash-attention rows of chip_smoke.py's kernel line for several
trees, each in a fresh process, in the order given.

    python3 ab_flash.py build/parent . . build/parent [--ring 64:16:3 ...]

Each argument is a checkout of the repository ('.' is this one; unpack the
parent with `git archive <commit> | tar -x -C build/parent`). Each `--ring
HD:KEYS:STAGES` adds, after the trees, a copy of this tree under
build/ab_flash/ whose bf16 split-KV decode at head dim HD takes subtiles of
KEYS keys, STAGES deep (`DecodeRing` in flash_attention.cu). A run builds
its tree's kernels, then times, with chip_smoke.time_ms (CUDA events,
median of 20, L2 flushed), the flash calls of the kernel line on the same
seeded inputs as chip_smoke's phase 7: the recurrentgemma-9b serving
decode and prefill, the three gemma2-9b rows, and the four launch-phase
rows, and each row's device time by kernel (the profiler's, in the run's
fresh process). Prints one JSON line a
run and, last, all runs with the card's name and power limit. Needs a
CUDA device.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
RING = """  static constexpr int kKeys = HD == 64 ? 64 : 16;
  static constexpr int kStages = HD == 256 ? 2 : 3;"""


def device_ms_by_kernel(fn, runs=5):
    """Device ms a call by kernel name (the profiler's CUDA kernels, the
    function's name without its namespace, template arguments and
    parameters), over `runs` calls; empty where the profiler records no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", ev.key.strip())
            name = re.split(r"[(<]", name, maxsplit=1)[0].split("::")[-1].strip()
            out[name] = out.get(name, 0.0) + us / 1e3 / runs
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def run(tree: Path):
    """In a fresh process: time the rows of `tree`; print their JSON line."""
    sys.path.insert(0, str(tree))
    import torch
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    cs.check_device()
    cs.build.build()
    gen = torch.Generator(device=dev).manual_seed(2)
    rows, kernels = {}, {}
    cases = [(kind,) + cs.slice_attention_inputs(kind, gen, dev)
             for kind in ("decode", "prefill")]
    for name, _ in cs.FAMILY_SHAPES:
        cases.append((name,) + cs.family_serving_inputs(name, gen, dev))
    for name, args, kw in cases:
        call = lambda: cs.ops.flash_attention(*args, **kw)  # noqa: E731
        rows[name] = cs.time_ms(call, dev)
        kernels[name] = device_ms_by_kernel(call)
    del cases
    for name in cs.LAUNCH_FLASH:
        args, kw = cs.launch_flash_inputs(name, gen, dev)
        call = lambda: cs.ops.flash_attention(*args, **kw)  # noqa: E731
        rows[name] = cs.time_ms(call, dev)
        kernels[name] = device_ms_by_kernel(call)
        del args, call
        torch.cuda.empty_cache()
    print(json.dumps({"tree": str(tree), "rows": rows, "kernels_ms": kernels}))


def ring_copy(spec: str) -> Path:
    """A copy of this tree with DecodeRing<HD> at KEYS keys, STAGES deep."""
    hd, keys, stages = (int(x) for x in spec.split(":"))
    tree = ROOT / "build" / "ab_flash" / f"ring_{hd}_{keys}_{stages}"
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "src", tree / "src", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tree / "chip_smoke.py")
    text = (tree / SOURCE).read_text()
    if text.count(RING) != 1:
        raise RuntimeError(f"DecodeRing is not as ab_flash.py expects in {SOURCE}")
    text = text.replace(RING, f"""  static constexpr int kKeys = HD == {hd} ? {keys} : (HD == 64 ? 64 : 16);
  static constexpr int kStages = HD == {hd} ? {stages} : (HD == 256 ? 2 : 3);""")
    (tree / SOURCE).write_text(text)
    return tree


def main(argv):
    if argv[:1] == ["--run"]:
        run(Path(argv[1]).resolve())
        return 0
    trees, rings, it = [], [], iter(argv)
    for a in it:
        if a == "--ring":
            rings.append(next(it))
        else:
            trees.append(Path(a).resolve())
    trees += [ring_copy(spec) for spec in rings]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    runs = []
    for tree in trees:
        res = subprocess.run([sys.executable, __file__, "--run", str(tree)], cwd=tree,
                             capture_output=True, text=True, timeout=600)
        if res.returncode:
            print(res.stdout + res.stderr)
            raise RuntimeError(f"{tree}: exit {res.returncode}")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    print(json.dumps({"card": re.sub(r"\s+", " ", card).strip(), "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
