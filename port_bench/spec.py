"""A cell of `BENCHMARK.json` and the files found by its names."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The workload's entry, its configuration, traffic mix and limits, and
    the metrics it reports. Raises where a name has no file. `root` holds
    `BENCHMARK.json` and the benchmark's directory."""
    root = Path(root)
    here = root / HERE.name
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if workload not in work:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"cells: {', '.join(sorted(work))}")
    w = work[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def reports(m):
        return "workloads" not in m or workload in m["workloads"]

    return {
        "workload": w,
        "dir": here,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        "limits": json.loads((here / "limits" / f"{workload}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def constants(config: dict, traffic: dict) -> dict:
    """The constants of the system model as the cell runs them: the
    configuration's groups with the traffic mix's road overrides."""
    return {**config["genfv"], **traffic["road"], **config["gpu_model"],
            **config["diffusion_service"]}


def generator_block(config: dict) -> dict:
    """The configuration's AIGC generator: its `generator` block (kind,
    sampler_steps, the reference module's name, shape keys), or, without
    one, the generator `fl.generator` names with the reference module of
    the same name; with the dataset's name."""
    kind = config["fl"]["generator"]
    block = config.get("generator") or {"kind": kind, "reference": kind}
    return {**block, "dataset": config["dataset"]["name"]}


def load_generator(name: str, here: Path = HERE):
    """The generator reference `reference/generators/<name>.py` under the
    benchmark's directory `here`, loaded once a process."""
    path = Path(here) / "reference" / "generators" / f"{name}.py"
    key = f"port_bench.reference.generators.{name}"
    mod = sys.modules.get(key)
    if mod is not None and Path(mod.__file__).resolve() == path.resolve():
        return mod
    if not path.is_file():
        raise KeyError(f"no generator reference {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def reference_cell(cell: dict) -> dict:
    """What the reference round needs to know of the cell."""
    config, traffic = cell["config"], cell["traffic"]
    c = constants(config, traffic)
    return {"c": c, "model": config["model"], "dataset": config["dataset"]["name"],
            "classes": config["dataset"]["classes"], "strategy": traffic["strategy"],
            "local_steps": c["local_steps"], "batch_size": c["batch_size"],
            "rsu_steps_factor": c["rsu_steps_factor"],
            "client_lr": config["fl"]["client_lr"],
            "select_fraction": traffic.get("select_fraction", 0.0),
            "generator": generator_block(config), "dir": cell.get("dir", HERE),
            "world_seed": traffic["world_seed"]}
