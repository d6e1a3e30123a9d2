"""One run of one cell: set-up, warm-up, the window, the output check, and
the result's line."""
from __future__ import annotations

import gc
import importlib.util
import subprocess
import sys
import time

import torch

from port_bench import check as chk
from port_bench import host
from port_bench.flops import forward_flops, train_flops
from port_bench.harness import build, warm_up, window
from port_bench.peaks import peak
from port_bench.spec import HERE, generator_block, load_generator, reference_cell

#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class ForbiddenModules(RuntimeError):
    pass


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def read_metric(name: str, trace: dict):
    """The per-layer metric `name`, read by `metrics/<name>.py`; None where
    the trace holds nothing for it."""
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


def card_line(device) -> str:
    if device.type != "cuda":
        return f"device: {device}"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=20)
        return f"card: {smi.stdout.strip() or 'power limit not read'}"
    except (OSError, subprocess.SubprocessError):
        return "card: power limit not read"


def round_record(r: dict, cfg, strategy: str, n_test: int, image_flops: float = 0.0) -> dict:
    """What the metric readers take of a round. `image_flops` is one
    generated image's FLOPs over all its denoising steps."""
    aug = strategy == "genfv" and r["pool_n"] + int(r["plan"].b_gen) >= 2
    generated = 0 if r.get("gen") is None else len(r["gen"])
    return {"ms": r["ms"], "wall_ms": r["wall_ms"], "selected": r["log"].selected,
            "syncs": r["plan"].syncs, "profiled": r["profiled"],
            "plan_steps": sum(getattr(r["plan"], "steps", {}).values()),
            "fleet_images": r["log"].selected * cfg.local_steps * cfg.batch_size,
            "aug_images": (cfg.local_steps * cfg.rsu_steps_factor * cfg.batch_size
                           if aug else 0),
            "eval_images": n_test, "gen_flops": generated * image_flops}


def measure(cell: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float, log=print) -> dict:
    """Set-up, warm-up and the window; then the program's state is freed
    but for what the output check reads of the rounds it samples."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"
    traffic = cell["traffic"]

    phases = {"start": time.perf_counter() - t_start}
    runner, rec, train, test = build(cell, seed, device, timed=trace, phases=phases)
    t0 = time.perf_counter()
    warm_up(runner, traffic, device)
    phases["warm_up"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = host.counters()
    rounds, window_s, prof = window(runner, rec, seconds, traffic["cycle_rounds"],
                                    tuple(traffic["profile_rounds"]) if trace else ())
    after = host.counters()
    mem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if forbidden_modules():
        raise ForbiddenModules(", ".join(forbidden_modules()))

    block = generator_block(cell["config"])
    image_flops = (block.get("sampler_steps", 0)
                   * load_generator(block["reference"], cell["dir"]).step_flops(block))
    records = [round_record(r, runner.cfg, traffic["strategy"], len(test[1]), image_flops)
               for r in rounds]
    picked = chk.sample_rounds(rounds, seed, traffic["checked_rounds"])
    for i, r in enumerate(rounds):          # keep what the check reads
        if i not in picked:
            r.update(p0=None, aug=None)
    del runner, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log(card_line(device))
    log(f"window: {len(rounds)} rounds in {window_s:.3f} s, selected "
        f"{[x['selected'] for x in records]}, b_gen {[int(r['plan'].b_gen) for r in rounds]}, "
        f"ms {[round(x['wall_ms'], 1) for x in records]}; "
        f"checked rounds {picked}; max_memory_allocated {mem_peak} bytes")
    log("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    log(host.line(before, after, window_s))
    return {"rounds": rounds, "records": records, "picked": picked, "setup_s": setup_s,
            "window_s": window_s, "mem_peak": mem_peak, "profile": prof,
            "train": train, "test": test}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print) -> tuple[dict, list]:
    """Returns (the result's dict, the check's lines). Raises
    ForbiddenModules where the process has loaded JAX or the JAX package."""
    cuda = device.type == "cuda"
    config, traffic = cell["config"], cell["traffic"]
    w = measure(cell, seed, seconds, trace, device, t_start, log)
    rounds, records, prof = w["rounds"], w["records"], w["profile"]

    ref = chk.Reference(reference_cell(cell), w["train"], w["test"],
                        traffic["world_seed"], device, seed)
    limits = cell["limits"]
    per_round = chk.check(ref, rounds, w["picked"])
    verdict = chk.judge(chk.worst(per_round, limits), limits)
    # rounds over a limit; a number judged by a median or least over the
    # rounds counts once where that fails
    failed = sum(1 for x in per_round.values()
                 if any(x[k] > limits[k] for k in limits
                        if k in x and k not in ("loss_gap", "aug_loss_gap")))
    failed += sum(int(not verdict[k]["ok"]) for k in ("loss_gap", "aug_loss_gap")
                  if k in verdict)
    for i, x in per_round.items():
        if i in w["picked"]:
            log(f"round {i} (selected {records[i]['selected']}): "
                + ", ".join(f"{k} {v!r}" for k, v in x.items()))
    for k in ("plan_gap", "eval_gap", "gen_gap"):
        if k in limits:
            log(f"{k} by round: " + ", ".join(f"{per_round[i][k]:.3g}" for i in sorted(per_round)
                                               if k in per_round[i]))

    if trace:
        model = config["model"]
        tr = {"rounds": records, "profile": prof,
              "flops": {"forward": forward_flops(model), "train": train_flops(model)},
              "peak_flops": peak(torch.cuda.get_device_name(device) if cuda else "",
                                 config["precision"]["model"])}
        metrics = {}
        for m in cell["per_layer"]:
            v = read_metric(m["name"], tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        images = sum(x["fleet_images"] + x["aug_images"] for x in records)
        values = {"setup_s": w["setup_s"], "round_ms": 1e3 * w["window_s"] / len(rounds),
                  "sgd_images_per_s": images / w["window_s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else str(device),
           "count": 1, "memory_peak_bytes": int(w["mem_peak"])}
    result = {"correct": all(v["ok"] for v in verdict.values()),
              "attempted": len(rounds), "failed": failed, "metrics": metrics,
              "device": dev}
    if trace and prof:
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": [list(x) for x in prof["device_ops"]],
                               "idle_gaps": [list(x) for x in prof["idle_gaps"]]}
    if forbidden_modules():
        raise ForbiddenModules(", ".join(forbidden_modules()))
    result["check"] = {k: {"value": v["value"], "limit": v["limit"]}
                       for k, v in verdict.items()}
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r}) "
             f"{'ok' if v['ok'] else 'FAILED'}" for k, v in verdict.items()]
    return result, lines
