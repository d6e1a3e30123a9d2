"""The result's line of a run, driven on the CPU at a small size."""
import json
import subprocess
import sys
import time

import pytest
import torch

from port_bench.runcell import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
def test_line_shape(small, trace):
    cell = small("cifar10.genfv-highway")
    result, lines = run_cell(cell, 2 ** 31 + 17, 0.2, bool(trace), torch.device("cpu"),
                             time.perf_counter(), log=lambda m: None)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == KEYS and list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    names = [m["name"] for m in (cell["per_layer"] if trace else cell["end_to_end"])]
    # the idle share needs the CUDA profiler, the MFUs a peak of the device:
    # silent on the CPU
    want = [n for n in names if n not in ("device_idle_share", "fleet_mfu", "round_mfu")]
    assert sorted(line["metrics"]) == sorted(want)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["check"]) == set(cell["limits"])
    assert [ln.split()[1].rstrip(":") for ln in lines] == list(cell["limits"])


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command exits non-zero and prints no line."""
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          "cifar10.genfv-highway", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=str(__import__("port_bench").__path__[0] + "/.."))
    assert out.returncode != 0 and out.stdout == ""


class StepClock:
    """A clock that moves one second each time it is read, so that a window
    of 10.5 "seconds" holds four rounds however fast the machine runs: the
    window reads it once at its start and three times a round."""
    t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def test_window_replays_the_road(small, monkeypatch):
    """Every cycle_rounds rounds the world and the random stream start over:
    round t + cycle draws what round t drew."""
    from port_bench import harness
    from port_bench.runcell import measure
    cell = small("cifar10.genfv-highway")
    cell["traffic"]["cycle_rounds"] = 2
    monkeypatch.setattr(harness, "time", StepClock())
    w = measure(cell, 7, 10.5, False, torch.device("cpu"), time.perf_counter(),
                log=lambda m: None)
    rounds = w["rounds"]
    assert len(rounds) == 4
    for key in ("rng_generate", "rng_local_sgd"):
        assert rounds[0][key] == rounds[2][key] and rounds[1][key] == rounds[3][key]
        assert rounds[0][key] != rounds[1][key]
    assert [r["selected"] for r in w["records"][:2]] == [r["selected"] for r in w["records"][2:4]]
