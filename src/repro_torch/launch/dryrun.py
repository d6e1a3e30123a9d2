"""Dry-run of every (architecture x input shape) pair: whether its step
fits, and its roofline terms on H100 cards (the counterpart of the JAX
package's `launch/dryrun.py`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes | --mesh 1x1]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
      --shape decode_32k --mesh 1x1 --execute --batch 8  (on the card)

The JAX dry-run lowers and compiles each step for the production mesh and
reads its memory and cost analyses. Eager PyTorch has no compile step, so
this one does two things instead:

(a) The meta trace. The step runs once on meta tensors (`launch.specs`:
    shapes and dtypes, no storage): the plain torch route (`impl="torch"`,
    the JAX dry-run's `impl="jnp"`), with remat and AdamW at a constant
    1e-4 for train. It checks the shape of every op at full size, and
    counts FLOPs as `torch.utils.flop_counter.FlopCounterMode` does (its
    formulas, its decomposition of composite ops) in place of
    `cost_analysis()`; it counts each executed op, so it needs no
    loop-trip scaling. It runs under `MetaTrace`, not FlopCounterMode
    itself: most meta functions are Python, and a step loops over kv
    chunks or the sequence hundreds of thousands of times, so `MetaTrace`
    keeps each pure op's output shapes and FLOPs by its inputs'
    shapes, strides and dtypes and answers a repeat from that (held to
    FlopCounterMode and to an uncached trace by tests/test_torch_launch.py).
    A step whose Python loops (the plain RG-LRU and sLSTM loops over the
    sequence, the attention's q x kv chunk loop, the dense MoE's expert
    loop) would dispatch more than TRACE_OP_LIMIT ops is not traced: its
    record says `trace: skipped (...)` and gives the analytic terms alone.
    That is a limit of tracing, not a fallback on the card.
(b) `execute=True` builds the arguments for real on `device`, at full width
    with random weights from seed 0 (the batch cut to `batch` where given),
    and runs the step through the port's normal route: the kernels for
    prefill and decode, `impl="torch"` for train. It records the median
    wall time of 5 runs after a warm-up (the device synchronized at the
    edges), the peak memory against the argument bytes (the difference
    stands for the compiled step's temp bytes), and the kernels' launches.

(c) The collective trace, on each mesh of more than one card. The step
    runs once more on meta DTensors over a DeviceMesh of the mesh's axes
    (`launch.mesh.device_mesh`, a fake process group: this process is
    rank 0 and nothing moves), its arguments placed by `build_shardings`,
    under `activation_sharding` (the models' `aconstrain` pins the JAX
    package's layouts) on the plain torch route, and its outputs
    redistributed to the JAX dry-run's `out_shardings` (logits by the batch
    rule, train outputs as their inputs, the metrics replicated).
    `CollectiveCounter` adds up the bytes of each collective's output on
    the rank, by the JAX HLO kind. Loop scaling follows the JAX count,
    which scales the layer scan's body by `loop_trip_count(cfg)` and counts
    the remainder layers and everything outside the scan once: the step is
    traced cut to one pattern group plus the remainder (A) and to two
    groups plus the remainder (B); B - A is one group's collectives, and
    the record gives A + (trip - 1) (B - A). A config of fewer than two
    groups is traced whole. A pair whose two traces would dispatch more
    than COLLECTIVE_OP_LIMIT ops in their loops is not traced (None, and
    a note naming the limit). On 2x16x16 the trace runs on the 32x16 mesh
    with the pod axis folded into data (`launch.mesh.fold_pods`), which
    lays every tensor out on the same ranks: DTensor plans a step on a
    three-dim mesh 25 times more slowly.

The roofline terms are the analytic model (`launch.analysis`) over
n_cards x `H100`. On a 1x1 mesh the collective term is 0, which is exact;
on a larger mesh it is (c)'s bytes over n_cards x `H100.ici_bw`, the JAX
dry-run's formula (which divides one device's bytes by the number of cards
a second time: ROADMAP.md Queue 3 keeps that as a reference defect, and the
port keeps it so that the records compare). `dominant` is the largest of
the three terms. Records go to `dryrun_torch_<arch>_<shape>_<mesh>.json`
under `--out` (default `artifacts/torch_dryrun/`).

Record keys that differ from the JAX dry-run's: `trace_s` stands for
`lower_s` and `compile_s`; `flop_counter_global` (and
`flop_counter_by_op`) for `hlo_flops_global_crosscheck`;
`memory.argument_size_in_bytes` is `distributed.sharding.per_device_bytes`
of the argument specs under the mesh's sharding rules; `execute` holds
(b). The JAX record's `cost_per_device_raw`, `hlo_bytes_global_crosscheck`
and the other `memory_analysis()` fields have no counterpart.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import time

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, BLOCK_RGLRU,
                                      BLOCK_SLSTM, H100)
from repro_torch.distributed.autoshard import activation_sharding
from repro_torch.distributed.sharding import (batch_shardings, cache_shardings, distribute,
                                              params_shardings, per_device_bytes, placements)
from repro_torch.kernels import ops
from repro_torch.launch import specs as S
from repro_torch.launch.analysis import (executed_bytes, executed_flops,
                                         loop_trip_count, model_flops)
from repro_torch.launch.mesh import (MeshSpec, device_mesh, fold_pods, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.metatrace import CollectiveCounter, MetaTrace
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import KV_CHUNK
from repro_torch.obs import log_line
from repro_torch.optim import adamw, constant_schedule
from repro_torch.tree import tree_leaves

# Ops one step of each Python loop dispatches on the plain route, as
# MetaTrace counts them at full width (the difference between traces at two
# sizes, tests/test_torch_launch.py::test_loop_ops_are_metatrace_counts):
# a step of sdpa_chunked's q x kv loop 39 and each q block 11 more, a step
# of lru_scan 4, of the sLSTM 36, an expert of the dense MoE 12.
# A train step dispatches 5.0-7.2 times its forward's loop ops (forward,
# recompute, backward; recurrentgemma-9b 5.0, xlstm-1.3b 5.8, qwen1.5-0.5b
# 7.2). PERF.md §5 gives MetaTrace's time an op on the card's host;
# TRACE_OP_LIMIT keeps a trace under about 80 s (module docstring, (a)).
LOOP_OPS = {"attention": 39, "attention_q": 11, "rglru": 4, "slstm": 36, "moe": 12}
TRAIN_PASSES = 6
TRACE_OP_LIMIT = 4_000_000
# the collective trace's DTensor dispatch costs more an op than MetaTrace's
COLLECTIVE_OP_LIMIT = 2_000_000
Q_CHUNK = 512      # sdpa_chunked's q block
EXECUTE_RUNS = 5


def _log(text):
    """Every line lands (no rate limit), through the port's progress log."""
    log_line(None, "launch/dryrun", text, force=True)


def long_window_for(cfg, shape_name: str):
    """gemma2 serves long_500k through its local-window variant."""
    if shape_name == "long_500k" and cfg.name.startswith("gemma2"):
        return cfg.sliding_window
    return None


def build_step(cfg, shape, optimizer, long_window=None, impl="torch"):
    if shape.kind == "train":
        return api.make_train_step(cfg, optimizer, remat=True)
    if shape.kind == "prefill":
        return api.make_prefill_step(cfg, impl=impl, long_window=long_window)
    return api.make_decode_step(cfg, impl=impl, long_window=long_window)


def build_shardings(cfg, mesh, args, kind):
    """Specs of the step's arguments under the sharding rules."""
    p_sh = params_shardings(args[0], mesh, cfg)
    if kind == "train":
        return (p_sh, params_shardings(args[1], mesh, cfg),
                batch_shardings(args[2], mesh))
    c_sh = cache_shardings(args[1], mesh)
    if kind == "prefill":
        return (p_sh, c_sh, batch_shardings(args[2], mesh))
    return (p_sh, c_sh, batch_shardings(args[2], mesh), batch_shardings(args[3], mesh))


def trace_ops(cfg, shape, moe_mode="dense"):
    """(ops, what): about how many ops the step's Python loops dispatch on
    the plain route (LOOP_OPS per loop step, TRAIN_PASSES times for
    train), and the largest loop named."""
    Sq = 1 if shape.kind == "decode" else shape.seq_len
    q_chunks = -(-Sq // Q_CHUNK)
    loops = {}                      # name -> (ops, layers)

    def add(name, steps, per_step):
        ops, layers = loops.get(name, (0, 0))
        loops[name] = (ops + steps * per_step, layers + 1)

    for kind in cfg.layer_kinds:
        if kind in (ATTN_GLOBAL, ATTN_LOCAL):
            cap = shape.seq_len      # a local layer's cache holds the window
            if shape.kind != "train" and kind == ATTN_LOCAL and cfg.sliding_window:
                cap = min(cap, cfg.sliding_window)
            add("attention q x kv chunk loop", q_chunks,
                LOOP_OPS["attention"] * -(-cap // KV_CHUNK) + LOOP_OPS["attention_q"])
            if cfg.moe is not None and moe_mode == "dense":
                add("dense MoE expert loop", cfg.moe.num_experts, LOOP_OPS["moe"])
        elif kind == BLOCK_RGLRU and Sq > 1:
            add(f"RG-LRU loop over S = {Sq}", Sq, LOOP_OPS["rglru"])
        elif kind == BLOCK_SLSTM:
            add(f"sLSTM loop over S = {Sq}", Sq, LOOP_OPS["slstm"])
    passes = TRAIN_PASSES if shape.kind == "train" else 1
    ops = passes * sum(n for n, _ in loops.values())
    what, (_, layers) = max(loops.items(), key=lambda kv: kv[1][0])
    return ops, f"{what} in {layers} layers; about {ops:,} ops"


def meta_trace(cfg, shape, optimizer, dtype, long_window, moe_mode):
    """Runs the step once on meta tensors under MetaTrace; returns the
    record's trace fields."""
    ops, what = trace_ops(cfg, shape, moe_mode)
    if ops > TRACE_OP_LIMIT:
        return {"trace": f"skipped ({what}; limit {TRACE_OP_LIMIT:,})",
                "trace_s": None, "flop_counter_global": None}
    args, kind = S.input_specs(cfg, shape, optimizer, dtype=dtype)
    step = build_step(cfg, shape, optimizer, long_window, impl="torch")
    t0 = time.perf_counter()
    with MetaTrace() as mt:
        out = step(*args)
    t = time.perf_counter() - t0
    if kind == "train":
        outputs = {k: list(v.shape) for k, v in out[2].items()}
    else:
        outputs = {"logits": list(out[0].shape)}
    return {"trace": f"meta ({what})", "trace_s": t,
            "flop_counter_global": float(sum(mt.flops.values())),
            "flop_counter_by_op": {str(k): float(v) for k, v in mt.flops.items()},
            "trace_ops": mt.calls, "trace_cache_hits": mt.hits, "outputs": outputs}


def cut_to_groups(cfg, groups: int):
    """cfg cut to `groups` pattern groups plus its remainder layers (the
    sharding rules treat each kept layer as the full config does)."""
    plen = len(cfg.pattern)
    return dataclasses.replace(cfg, num_layers=groups * plen + cfg.num_layers % plen)


def _collective_cuts(cfg):
    """The configs (c) traces: the whole config below two groups, else one
    and two groups plus the remainder."""
    if cfg.num_layers // len(cfg.pattern) < 2:
        return [cfg]
    return [cut_to_groups(cfg, 1), cut_to_groups(cfg, 2)]


def _out_specs(out, mesh_spec, kind, specs):
    """The JAX dry-run's out_shardings: logits by the batch rule, train
    outputs as their inputs, the metrics replicated."""
    if kind == "train":
        return (specs[0], specs[1], {k: (None,) * v.ndim for k, v in out[2].items()})
    return (batch_shardings(out[0], mesh_spec), specs[1])


def count_collectives(cfg, shape, mesh_spec: MeshSpec, optimizer, *, dtype=torch.bfloat16,
                      long_window=None):
    """One collective trace ((c) of the module docstring) of `cfg` as given:
    (bytes by kind, calls by kind, ops dispatched)."""
    args, kind = S.input_specs(cfg, shape, optimizer, dtype=dtype)
    specs = build_shardings(cfg, mesh_spec, args, kind)
    step = build_step(cfg, shape, optimizer, long_window, impl="torch")
    from torch.distributed.tensor.experimental import implicit_replication
    with device_mesh(mesh_spec) as mesh:
        dargs = tuple(distribute(a, s, mesh) for a, s in zip(args, specs))
        with activation_sharding(mesh), implicit_replication(), MetaTrace() as mt, \
                CollectiveCounter() as cc:
            out = step(*dargs)
            _redistribute(out, _out_specs(out, mesh_spec, kind, specs), mesh)
    return dict(cc.bytes_by_kind), dict(cc.calls_by_kind), mt.calls


def _redistribute(out, specs, mesh):
    if isinstance(out, dict):
        for k, v in out.items():
            _redistribute(v, specs[k], mesh)
    elif isinstance(out, (list, tuple)):
        for v, s in zip(out, specs):
            _redistribute(v, s, mesh)
    elif isinstance(out, DTensor):
        out.redistribute(mesh, placements(specs, mesh))


def collective_trace(cfg, shape, mesh_spec: MeshSpec, optimizer, dtype, long_window,
                     moe_mode="dense"):
    """(c) of the module docstring: the record's collective fields."""
    trip = loop_trip_count(cfg)
    cuts = _collective_cuts(cfg)
    ops = sum(trace_ops(c, shape, moe_mode)[0] for c in cuts)
    if ops > COLLECTIVE_OP_LIMIT:
        what = trace_ops(cfg, shape, moe_mode)[1].split(";")[0]
        return {"collective_bytes_global": None, "collective_by_kind": None,
                "collective_note": (f"not traced: the collective trace's loops ({what}) would "
                                    f"dispatch about {ops:,} ops in its {len(cuts)} cuts, past "
                                    f"COLLECTIVE_OP_LIMIT {COLLECTIVE_OP_LIMIT:,}"),
                "collective_trace_s": None}
    traced = fold_pods(mesh_spec)
    t0 = time.perf_counter()
    counts = [count_collectives(c, shape, traced, optimizer, dtype=dtype,
                                long_window=long_window) for c in cuts]
    t = time.perf_counter() - t0
    by_kind, calls = dict(counts[0][0]), dict(counts[0][1])
    if len(counts) == 2:
        for kinds, cnt in ((by_kind, 0), (calls, 1)):
            for k in set(counts[0][cnt]) | set(counts[1][cnt]):
                a, b = counts[0][cnt].get(k, 0), counts[1][cnt].get(k, 0)
                kinds[k] = a + (trip - 1) * (b - a)
    how = ("the whole config traced" if len(counts) == 1 else
           f"traced at 1 and 2 pattern groups plus the remainder; one group's "
           f"collectives (the difference) scaled by the trip count {trip}")
    return {"collective_bytes_global": float(sum(by_kind.values())),
            "collective_by_kind": {k: float(v) for k, v in sorted(by_kind.items())},
            "collective_calls_by_kind": dict(sorted(calls.items())),
            "collective_note": (f"bytes of each collective's output on one rank, by the JAX HLO "
                                f"kind, from a DTensor trace on a fake {traced.name} mesh "
                                f"({how}); the term divides them by n_cards x ici_bw as the "
                                f"JAX dry-run does (ROADMAP.md Queue 3)"),
            "collective_trace_s": t, "collective_trace_ops": sum(c[2] for c in counts)}


def collective_term(cbytes: float, n_cards: int) -> float:
    """The JAX dry-run's collective term: one rank's collective bytes over
    n_cards x the link rate (ROADMAP.md Queue 3: understated n_cards-fold;
    kept so that the records compare)."""
    return cbytes / (n_cards * H100.ici_bw)


def roofline(cfg, shape, n_cards: int, *, moe_mode, long_window):
    ex_f = executed_flops(cfg, shape, moe_mode=moe_mode, long_window=long_window)
    ex_b = executed_bytes(cfg, shape, moe_mode=moe_mode, long_window=long_window)
    return (ex_f, ex_b, ex_f["total"] / (n_cards * H100.peak_flops),
            ex_b["total"] / (n_cards * H100.hbm_bw))


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def fill_cache(cache, n_written: int, gen):
    """A decode cache as it stands after n_written tokens: each attention
    layer's k and v random normal, slot j holding the latest position
    p < n_written with p % cap == j (-1 where none), the cursor at
    n_written. Recurrent states keep their initial values."""
    for layer in cache["layers"]:
        kv = layer.get("kv")
        if kv is None:
            continue
        cap = kv["k"].shape[1]
        j = torch.arange(cap, device=kv["pos"].device)
        last = n_written - 1 - j
        pos = torch.where(last >= 0, j + cap * torch.div(last, cap, rounding_mode="floor"), -1)
        kv["pos"].copy_(pos.to(torch.int32).expand_as(kv["pos"]))
        kv["idx"].fill_(n_written)
        kv["k"].normal_(generator=gen)
        kv["v"].normal_(generator=gen)
    return cache


def _real_args(cfg, shape, kind, optimizer, dtype, device, gen):
    """The step's arguments, built for real on `device` from `gen`."""
    B, Sl = shape.global_batch, shape.seq_len
    params = api.init_params(gen, cfg, dtype=dtype, device=device)

    def rand_like(name, spec):
        if name == "mask":
            return torch.ones(tuple(spec.shape), dtype=spec.dtype, device=device)
        if spec.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, tuple(spec.shape), generator=gen,
                                 device=device, dtype=torch.int32)
        return torch.randn(tuple(spec.shape), generator=gen, device=device, dtype=spec.dtype)

    if kind == "train":
        batch = {k: rand_like(k, v) for k, v in
                 S.batch_specs(cfg, shape, train=True, dtype=dtype).items()}
        return (params, optimizer.init(params), batch)
    cache = api.init_cache(cfg, B, Sl, dtype, device)
    if kind == "prefill":
        batch = {k: rand_like(k, v) for k, v in
                 S.batch_specs(cfg, shape, train=False, dtype=dtype).items()}
        return (params, cache, batch)
    fill_cache(cache, Sl - 1, gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=device,
                           dtype=torch.int32)
    positions = torch.full((B, 1), Sl - 1, dtype=torch.int32, device=device)
    return (params, cache, tokens, positions)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute_step(cfg, shape, optimizer, dtype, long_window, device, runs=EXECUTE_RUNS):
    """(b) of the module docstring: the record's `execute` fields."""
    device = api.resolve_device(device)
    kind = shape.kind
    gen = torch.Generator(device=device).manual_seed(0)
    args = _real_args(cfg, shape, kind, optimizer, dtype, device, gen)
    arg_bytes = _tensor_bytes(args)
    step = build_step(cfg, shape, optimizer, long_window,
                      impl="torch" if kind == "train" else "kernel")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = (ops.flash_attention.launches, ops.rglru_scan.launches)
    out = step(*args)
    if kind == "train":
        loss = float(out[2]["loss"])
        finite = bool(torch.isfinite(out[2]["loss"]))
    else:
        loss = None
        finite = bool(torch.isfinite(out[0]).all())
    del out
    ms = []
    for _ in range(runs):
        _sync(device)
        t0 = time.perf_counter()
        out = step(*args)
        _sync(device)
        ms.append(1e3 * (time.perf_counter() - t0))
        del out
    calls = runs + 1
    rec = {"device": torch.cuda.get_device_name(device) if cuda else "cpu",
           "batch": shape.global_batch, "runs": runs, "wall_ms": statistics.median(ms),
           "wall_ms_runs": ms, "argument_bytes": arg_bytes,
           "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
           "flash_launches_per_call": (ops.flash_attention.launches - launches0[0]) / calls,
           "scan_launches_per_call": (ops.rglru_scan.launches - launches0[1]) / calls,
           "outputs_finite": finite, "loss": loss}
    rec["temp_bytes"] = None if rec["peak_bytes"] is None else rec["peak_bytes"] - arg_bytes
    return rec


@contextlib.contextmanager
def _moe_mode(mode: str):
    old = tfm.get_moe_mode()
    tfm.set_moe_mode(mode)
    try:
        yield
    finally:
        tfm.set_moe_mode(old)


def dryrun_pair(arch: str, shape_name: str, meshes, *, dtype=torch.bfloat16,
                moe_mode: str = "dense", cfg_overrides: dict | None = None,
                tag: str = "baseline", execute: bool = False, device="cuda",
                batch: int | None = None, trace: bool = True, verbose: bool = True):
    """One record per mesh in `meshes`, from one meta trace (and one
    execution, where asked) of the pair, and one collective trace per mesh
    of more than one card. `batch` cuts the shape's global batch (the
    record names the cut); `trace=False` leaves the meta trace out (a
    caller that traced the pair already)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = INPUT_SHAPES[shape_name]
    cut_from = None
    if batch is not None and batch != shape.global_batch:
        cut_from = shape.global_batch
        shape = dataclasses.replace(shape, global_batch=batch)
    ok, note = S.runnable(cfg, shape)
    if not ok:
        return [{"arch": arch, "shape": shape_name, "skipped": True, "note": note,
                 "mesh": mesh.shape} for mesh in meshes]
    long_window = long_window_for(cfg, shape_name)
    optimizer = adamw(constant_schedule(1e-4))
    with _moe_mode(moe_mode):
        traced = (meta_trace(cfg, shape, optimizer, dtype, long_window, moe_mode)
                  if trace else {"trace": "not run", "trace_s": None,
                                 "flop_counter_global": None})
        ran = (execute_step(cfg, shape, optimizer, dtype, long_window, device)
               if execute else None)
    args, kind = S.input_specs(cfg, shape, optimizer, dtype=dtype)
    trip = loop_trip_count(cfg)
    mf = model_flops(cfg, shape)
    records = []
    for mesh in meshes:
        n = mesh.size
        specs = build_shardings(cfg, mesh, args, kind)
        arg_bytes = per_device_bytes(args, specs, mesh)
        ex_f, ex_b, compute_term, memory_term = roofline(
            cfg, shape, n, moe_mode=moe_mode, long_window=long_window)
        terms = {"compute": compute_term, "memory": memory_term}
        if n == 1:
            coll = {"collective_bytes_global": 0.0, "collective_by_kind": {},
                    "collective_note": "one card: no collective", "collective_trace_s": None}
        else:
            with _moe_mode(moe_mode):
                coll = collective_trace(cfg, shape, mesh, optimizer, dtype, long_window,
                                        moe_mode)
        cbytes = coll["collective_bytes_global"]
        coll_term = None if cbytes is None else collective_term(cbytes, n)
        if coll_term is not None:
            terms["collective"] = coll_term
            dom_note = "largest of the compute, memory and collective terms"
        else:
            dom_note = ("largest of the compute and memory terms; the collective term is "
                        "not measured: " + coll["collective_note"])
        rec = {
            "arch": arch, "shape": shape_name, "kind": kind, "tag": tag,
            "mesh": mesh.shape, "chips": n, "dtype": str(dtype).replace("torch.", ""),
            "batch": shape.global_batch, "batch_cut_from": cut_from,
            **traced,
            "memory": {"argument_size_in_bytes": arg_bytes},
            "fits_hbm": arg_bytes <= H100.hbm_bytes,
            "loop_trip_count": trip,
            "executed_flops_global": ex_f["total"],
            "executed_flops_breakdown": ex_f["breakdown"],
            "executed_bytes_global": ex_b["total"],
            "executed_bytes_breakdown": {k: v for k, v in ex_b.items() if k != "total"},
            **coll,
            "model_flops": mf,
            "useful_flops_ratio": mf / ex_f["total"] if ex_f["total"] else None,
            "moe_mode": moe_mode,
            "compute_term_s": compute_term,
            "memory_term_s": memory_term,
            "collective_term_s": coll_term,
            "dominant": max(terms, key=terms.get),
            "dominant_note": dom_note,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "skipped": False,
        }
        if ran is not None and n == 1:
            bound = max(compute_term, memory_term)
            ran = dict(ran, roofline_share=bound / (ran["wall_ms"] / 1e3),
                       bound_by="compute" if compute_term >= memory_term else "memory",
                       predicted_argument_bytes=arg_bytes)
            rec["execute"] = ran
        records.append(rec)
        if verbose:
            _log(f"[{arch} x {shape_name} x {mesh.name}] kind={kind} trace={rec['trace']} "
                  f"args/device={arg_bytes / 2**30:.2f}GiB compute={compute_term:.4g}s "
                  f"mem={memory_term:.4g}s"
                  + (f" coll={coll_term:.4g}s" if coll_term is not None else "")
                  + f" dom={rec['dominant']}"
                  + (f" wall={rec['execute']['wall_ms']:.2f}ms" if "execute" in rec else ""))
    return records


def dryrun_one(arch: str, shape_name: str, *, mesh: MeshSpec | None = None,
               dtype=torch.bfloat16, moe_mode: str = "dense",
               cfg_overrides: dict | None = None, tag: str = "baseline",
               execute: bool = False, device="cuda", batch: int | None = None,
               trace: bool = True, verbose: bool = True):
    """The record of one pair on `mesh` (default: the 16x16 production
    mesh, as in the JAX package); `dryrun_pair` for the options."""
    mesh = mesh if mesh is not None else make_production_mesh()
    return dryrun_pair(arch, shape_name, [mesh], dtype=dtype, moe_mode=moe_mode,
                       cfg_overrides=cfg_overrides, tag=tag, execute=execute,
                       device=device, batch=batch, trace=trace, verbose=verbose)[0]


def record_path(out: str, rec) -> str:
    mesh = "x".join(str(v) for v in rec["mesh"].values())
    return os.path.join(out, f"dryrun_torch_{rec['arch'].replace('.', '_')}_"
                             f"{rec['shape']}_{mesh}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", choices=("1x1",), default=None,
                    help="the card this process runs on instead of the production mesh")
    ap.add_argument("--out", default="artifacts/torch_dryrun")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--optimized", action="store_true",
                    help="beyond-paper config: expert-parallel sorted MoE + "
                         "vocab padding where the TP axis does not divide")
    ap.add_argument("--execute", action="store_true",
                    help="also run the step for real on --device (1x1 mesh only)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut each shape's global batch to this (the record names the cut)")
    args = ap.parse_args(argv)

    dtype = getattr(torch, args.dtype)
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    if args.mesh == "1x1":
        meshes = [make_host_mesh()]
    elif args.both_meshes:
        meshes = [make_production_mesh(), make_production_mesh(multi_pod=True)]
    else:
        meshes = [make_production_mesh(multi_pod=args.multi_pod)]
    if args.execute and args.mesh != "1x1":
        ap.error("--execute runs on the card: it needs --mesh 1x1")

    os.makedirs(args.out, exist_ok=True)
    results = []
    for arch in archs:
        for shape in shapes:
            kw = {}
            if args.optimized:
                kw["moe_mode"] = "sorted_grouped"
                kw["tag"] = "optimized"
                if get_config(arch).vocab_size % 16:
                    kw["cfg_overrides"] = {"pad_vocab_multiple": 2048}
            try:
                recs = dryrun_pair(arch, shape, meshes, dtype=dtype, execute=args.execute,
                                   device=args.device, batch=args.batch, **kw)
            except Exception as e:   # one failed pair is reported; the others run
                recs = [{"arch": arch, "shape": shape, "mesh": m.shape,
                         "error": f"{type(e).__name__}: {e}", "skipped": False}
                        for m in meshes]
                _log(f"[{arch} x {shape}] FAILED: {recs[0]['error']}")
            for rec in recs:
                results.append(rec)
                with open(record_path(args.out, rec), "w") as f:
                    json.dump(rec, f, indent=1)
    n_err = sum(1 for r in results if r.get("error"))
    n_skip = sum(1 for r in results if r.get("skipped"))
    _log(f"done: {len(results)} records, {n_err} errors, {n_skip} skipped")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
