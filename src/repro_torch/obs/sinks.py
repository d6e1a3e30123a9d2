"""Obs sinks of the port: JSONL event log, Chrome/Perfetto trace export,
and the versioned ``repro_torch.obs/metrics/v1`` artifact (the counterpart
of the JAX package's `obs/sinks.py`).

Metrics artifacts are written as ``<dir>/torch_<name>.metrics.json``
(default directory ``artifacts/``, override via ``REPRO_ARTIFACTS``), so
they never overwrite the JAX package's ``<name>.metrics.json``.
"""
from __future__ import annotations

import glob
import json
import os
import platform
from typing import Any, Dict, List

import torch

SCHEMA_PREFIX = "repro_torch.obs"
METRICS_SCHEMA = f"{SCHEMA_PREFIX}/metrics/v1"
#: file-name prefix of the port's metrics artifacts
ARTIFACT_PREFIX = "torch_"


def host_meta() -> Dict[str, Any]:
    """Host and device identification stamped into metrics artifacts and
    event logs: the torch and CUDA versions, the CUDA device's name and the
    device count (None and 0 without a card)."""
    cuda = torch.cuda.is_available()
    return {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_device": torch.cuda.get_device_name(0) if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "cpu_count": os.cpu_count(),
    }


# ---------------------------------------------------------------------------
# Metrics artifact.
# ---------------------------------------------------------------------------
def metrics_payload(obs, name: str = "run") -> Dict[str, Any]:
    payload = {
        "schema": METRICS_SCHEMA,
        "name": name,
        "meta": dict(obs.meta),
        "host": host_meta(),
        "events": len(obs.events),
        "open_spans": obs.open_spans,
    }
    payload.update(obs.metrics.payload())
    return payload


def save_metrics_artifact(payload: Dict[str, Any], name: str,
                          directory: str | None = None) -> str:
    """Write ``<dir>/torch_<name>.metrics.json``; returns the path."""
    if payload.get("schema") != METRICS_SCHEMA:
        raise ValueError(f"payload schema {payload.get('schema')!r} != "
                         f"{METRICS_SCHEMA!r}")
    # imported here: repro_torch.exp's sweep layer imports the round loop,
    # which imports this package
    from repro_torch.exp.artifacts import artifact_dir
    path = os.path.join(artifact_dir(directory),
                        f"{ARTIFACT_PREFIX}{name}.metrics.json")
    with open(path, "w") as f:
        json.dump(payload, f, sort_keys=True, indent=1, allow_nan=False)
        f.write("\n")
    return path


def load_metrics_artifact(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != METRICS_SCHEMA:
        raise ValueError(f"{path}: not a {METRICS_SCHEMA} artifact "
                         f"({doc.get('schema')!r})")
    return doc


def list_metrics_artifacts(directory: str | None = None) -> List[str]:
    d = directory or os.environ.get("REPRO_ARTIFACTS", "artifacts")
    return sorted(glob.glob(os.path.join(
        d, f"{ARTIFACT_PREFIX}*.metrics.json")))


# ---------------------------------------------------------------------------
# JSONL event log.
# ---------------------------------------------------------------------------
def write_jsonl(obs, path: str) -> str:
    """One JSON object per line: a header record, then every span/instant
    event in emission order."""
    with open(path, "w") as f:
        f.write(json.dumps({"schema": f"{SCHEMA_PREFIX}/events/v1",
                            "meta": obs.meta, "host": host_meta()},
                           sort_keys=True) + "\n")
        for ev in obs.events:
            f.write(json.dumps(ev, sort_keys=True) + "\n")
    return path


# ---------------------------------------------------------------------------
# Chrome / Perfetto trace.
# ---------------------------------------------------------------------------
def _tid(ev: Dict[str, Any]) -> int:
    """Track assignment: cells get their own rows, everything else shares
    track 0."""
    cell = ev.get("tags", {}).get("cell")
    return int(cell) + 1 if cell is not None else 0


def perfetto_payload(obs) -> Dict[str, Any]:
    """Chrome trace-event JSON (the `trace.json` flavor Perfetto's UI and
    `chrome://tracing` both load): complete ("X") events for spans —
    closed by construction — and instant ("i") events for the rest, all
    timestamps in microseconds from the tracer epoch."""
    events = []
    for ev in obs.events:
        args = {str(k): v for k, v in ev.get("tags", {}).items()}
        if "stage" in ev:
            args["stage"] = ev["stage"]
        rec = {"name": ev["name"], "ph": ev["ph"], "cat": "repro_torch",
               "ts": ev["ts"] * 1e6, "pid": 0, "tid": _tid(ev),
               "args": args}
        if ev["ph"] == "X":
            rec["dur"] = ev["dur"] * 1e6
        else:
            rec["s"] = "t"
        events.append(rec)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": f"{SCHEMA_PREFIX}/trace/v1",
                          **{str(k): str(v) for k, v in obs.meta.items()}}}


def write_trace(obs, path: str) -> str:
    if obs.open_spans:
        raise ValueError(f"{obs.open_spans} span(s) still open — export "
                         "traces only between rounds / after train()")
    with open(path, "w") as f:
        json.dump(perfetto_payload(obs), f)
        f.write("\n")
    return path
