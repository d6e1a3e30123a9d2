"""Published dense peaks of the devices a run may report (NVIDIA's H100
data sheet, SXM part, without sparsity, at the full 700 W power limit)."""
from __future__ import annotations

PEAKS = {
    "H100": {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
             "hbm_bytes_per_s": 3.35e12},
}


def peak(device_name: str, precision: str) -> float | None:
    """The peak of `precision` on the named device, or None where the table
    has no entry."""
    for key, row in PEAKS.items():
        if key in device_name:
            return row.get(precision)
    return None
