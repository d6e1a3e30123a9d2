#!/usr/bin/env python3
"""What flattening the mesh's dims changes in the dry-run's collective count.

For each pair of chip_smoke's `L1_AGAINST_JAX` (float32, cut to two pattern
groups plus the remainder, the 16x16 mesh: the count that L1 and
tests/test_torch_collectives.py hold to the JAX package), counts the
port's collectives twice, on a DeviceMesh whose dims are flattened (one
all-reduce for a pending sum over both dims, as `launch.mesh.device_mesh`
builds it) and on one whose dims are not (its `_flatten` patched to do
nothing: two sequential all-reduces, as before), each count in a fresh worker process (DTensor caches its
redistribute plans across meshes of the same shape, so a plan made on one
mesh would be reused on the other). Prints per pair the all-reduce
bytes and calls of each, the bytes the second all-reduce of each pair
added, the ratio JAX / port of each, and the call sites in the port of
every redistribute from a pending sum over both dims to replicated (the
innermost frame under src/repro_torch, with the tensor's shape). Host
work on the meta device; the torch version is printed beside it:
    python3 profile_collectives.py
"""
from __future__ import annotations

import ast
import contextlib
import json
import sys
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def _against_jax():
    """chip_smoke.L1_AGAINST_JAX, read from its source."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "L1_AGAINST_JAX"
                                                for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError("L1_AGAINST_JAX")


def _site(current, target, shape, sites):
    """Record the port's frame of a (Partial, Partial) -> (Replicate, Replicate)
    redistribute."""
    src, dst = current.placements, target.placements
    if len(src) > 1 and all(p.is_partial() for p in src) \
            and all(p.is_replicate() for p in dst):
        frames = [f for f in traceback.extract_stack()
                  if "repro_torch" in f.filename and "distributed/autoshard" not in f.filename]
        inner = [f for f in traceback.extract_stack() if "repro_torch" in f.filename]
        where = frames[-1] if frames else (inner[-1] if inner else None)
        via = inner[-1] if inner else None
        key = (f"{Path(where.filename).name}:{where.lineno} {where.name}" if where else "?",
               f"{Path(via.filename).name}:{via.lineno} {via.name}" if via else "?",
               str(list(shape)))
        sites[key] = sites.get(key, 0) + 1


@contextlib.contextmanager
def unflattened(on):
    """With on, `device_mesh` leaves the mesh's dims unflattened (its
    `_flatten` call does nothing), as before the port flattened them."""
    if not on:
        yield
        return
    from torch.distributed.device_mesh import DeviceMesh
    with mock.patch.object(DeviceMesh, "_flatten", lambda self, *a, **k: self):
        yield


def count(job):
    """(bytes by kind, calls by kind, sites) of one pair, flattened or not."""
    torch.set_num_threads(1)
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._api as api_mod
    import torch.distributed.tensor._redistribute as redist
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.dryrun import count_collectives, cut_to_groups
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.optim import adamw, constant_schedule
    (arch, shape), flatten = job
    sites = {}
    orig = redist.redistribute_local_tensor

    def hooked(local, current, target, *a, **k):
        _site(current, target, current.shape, sites)
        return orig(local, current, target, *a, **k)

    for mod in (redist, dispatch, api_mod):
        mod.redistribute_local_tensor = hooked
    with unflattened(not flatten):
        by_kind, calls, _ = count_collectives(
            cut_to_groups(get_config(arch), 2), INPUT_SHAPES[shape], make_production_mesh(),
            adamw(constant_schedule(1e-4)), dtype=torch.float32)
    return by_kind, calls, sites


def main():
    pairs = _against_jax()
    print(f"torch {torch.__version__}; float32, two pattern groups plus the remainder, 16x16")
    jobs = [(pair, flatten) for pair in pairs for flatten in (True, False)]
    with ProcessPoolExecutor(len(pairs), max_tasks_per_child=1) as pool:
        results = dict(zip(jobs, pool.map(count, jobs)))
    rows = {}
    for pair in pairs:
        (flat, flat_calls, sites), (seq, seq_calls, _) = (results[(pair, True)],
                                                           results[(pair, False)])
        jax_bytes = pairs[pair][0]
        ar_flat, ar_seq = flat.get("all-reduce", 0), seq.get("all-reduce", 0)
        t_flat, t_seq = sum(flat.values()), sum(seq.values())
        rows[f"{pair[0]} {pair[1]}"] = {
            "all_reduce_bytes": [ar_flat, ar_seq], "all_reduce_calls": [
                flat_calls.get("all-reduce", 0), seq_calls.get("all-reduce", 0)],
            "total_bytes": [t_flat, t_seq], "second_all_reduce_bytes": t_seq - t_flat,
            "ratio_jax_over_port": [round(jax_bytes / t_flat, 3), round(jax_bytes / t_seq, 3)],
            "other_kinds_equal": {k: v for k, v in flat.items() if k != "all-reduce"}
            == {k: v for k, v in seq.items() if k != "all-reduce"}}
        print(f"{pair[0]} {pair[1]}: all-reduce {ar_flat:,} bytes in "
              f"{flat_calls.get('all-reduce', 0)} calls flattened, {ar_seq:,} in "
              f"{seq_calls.get('all-reduce', 0)} not; the second all-reduces added "
              f"{t_seq - t_flat:,} bytes; JAX / port {jax_bytes / t_flat:.3f} flattened, "
              f"{jax_bytes / t_seq:.3f} not")
        for (where, via, shp), n in sorted(sites.items()):
            print(f"    {n} x (Partial, Partial) -> (Replicate, Replicate) of {shp} at {where}"
                  f" (through {via})")
    print(json.dumps({"torch": torch.__version__, "pairs": rows}))


if __name__ == "__main__":
    main()
