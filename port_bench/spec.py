"""A cell of `BENCHMARK.json` and the files found by its names."""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The workload's entry, its configuration, traffic mix and limits, and
    the metrics it reports. Raises where a name has no file."""
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
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        "limits": json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def constants(config: dict, traffic: dict) -> dict:
    """The constants of the system model as the cell runs them: the
    configuration's groups with the traffic mix's road overrides."""
    return {**config["genfv"], **traffic["road"], **config["gpu_model"],
            **config["diffusion_service"]}


def reference_cell(cell: dict) -> dict:
    """What the reference round needs to know of the cell."""
    config, traffic = cell["config"], cell["traffic"]
    c = constants(config, traffic)
    return {"c": c, "model": config["model"], "dataset": config["dataset"]["name"],
            "classes": config["dataset"]["classes"], "strategy": traffic["strategy"],
            "local_steps": c["local_steps"], "batch_size": c["batch_size"],
            "rsu_steps_factor": c["rsu_steps_factor"],
            "client_lr": config["fl"]["client_lr"],
            "select_fraction": traffic.get("select_fraction", 0.0)}
