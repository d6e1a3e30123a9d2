"""The host's side of a window, for the log: the CPU seconds the process
used in it and the CPUs it may run on. Rounds are host-bound for about
half their time, so a round's time follows the host's core."""
from __future__ import annotations

import os
import time


def counters() -> dict:
    return {"cpu_s": time.process_time()}


def line(before: dict, after: dict, window_s: float) -> str:
    used = after["cpu_s"] - before["cpu_s"]
    return (f"host: in the window's {window_s:.3f} s the process used {used:.3f} CPU s "
            f"({100 * used / window_s:.1f}% of one core); it may run on "
            f"{len(os.sched_getaffinity(0))} CPUs")
