"""Versioned JSON artifact store of the port's experiment outputs, a copy of
the JAX package's `exp/artifacts.py` under the port's schema prefix.

Every artifact is a single JSON object carrying a ``schema`` tag of the
form ``repro_torch.exp/<kind>/v<N>``; readers dispatch on it instead of
guessing at ad-hoc layouts. Files are written with sorted keys and fixed
separators so that re-running a deterministic producer rewrites the
byte-identical file (clean diffs).

Default location: ``artifacts/`` under the current working directory;
override per call or via ``REPRO_ARTIFACTS``.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List

SCHEMA_PREFIX = "repro_torch.exp"


def artifact_dir(directory: str | None = None) -> str:
    d = directory or os.environ.get("REPRO_ARTIFACTS", "artifacts")
    os.makedirs(d, exist_ok=True)
    return d


def schema_tag(kind: str, version: int = 1) -> str:
    return f"{SCHEMA_PREFIX}/{kind}/v{version}"


def _sanitize(obj):
    """JSON-safe copy: numpy scalars -> python, NaN/inf -> None."""
    import numpy as np
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [_sanitize(v) for v in obj.tolist()]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        obj = float(obj)
    if isinstance(obj, float):
        return obj if obj == obj and abs(obj) != float("inf") else None
    return obj


def save_artifact(name: str, kind: str, payload: Dict[str, Any],
                  directory: str | None = None, version: int = 1) -> str:
    """Write ``<dir>/<name>.<kind>.json`` with the schema tag injected.
    Returns the path."""
    doc = {"schema": schema_tag(kind, version)}
    doc.update(_sanitize(payload))
    path = os.path.join(artifact_dir(directory), f"{name}.{kind}.json")
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, indent=1, allow_nan=False)
        f.write("\n")
    return path


def load_artifact(path: str, kind: str | None = None) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    tag = doc.get("schema", "")
    if not tag.startswith(SCHEMA_PREFIX + "/"):
        raise ValueError(f"{path}: not a {SCHEMA_PREFIX} artifact ({tag!r})")
    if kind is not None and tag.split("/")[1] != kind:
        raise ValueError(f"{path}: expected kind {kind!r}, got {tag!r}")
    return doc


def list_artifacts(kind: str, directory: str | None = None) -> List[str]:
    d = directory or os.environ.get("REPRO_ARTIFACTS", "artifacts")
    return sorted(glob.glob(os.path.join(d, f"*.{kind}.json")))
