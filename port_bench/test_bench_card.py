"""On a CUDA device at the cell's own size: the program's readings pass the
limits, and those of the control (TF32, float32 planner), of omega_a
trained on half its batches and of each planted fault of the cell's
generator reference fail one. Run on the chip with
`python3 -m pytest -m card port_bench`."""
import json

import pytest

from port_bench.spec import ROOT, load_cell

#: every cell of the benchmark, those a later configuration adds too
WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_at_cell_size(card, workload):
    from port_bench import check as chk
    from port_bench.control import readings
    cell = load_cell(workload)
    out = readings(cell, 5_000_000_001, 10, card, log=lambda m: None)
    limits = cell["limits"]

    def passes(side):
        per_round = {i: r[side] if side in r else r["faults"][side]
                     for i, r in out["picked"].items()}
        return all(v["ok"] for v in chk.judge(chk.worst(per_round, limits), limits).values())
    assert passes("program")
    assert not passes("control")
    if "aug_loss_gap" in limits:
        assert not passes("aug_half_batch")
    if "gen_gap" in limits:
        from port_bench.spec import generator_block, load_generator
        block = generator_block(cell["config"])
        for fault in load_generator(block["reference"], cell["dir"]).FAULTS:
            assert not passes(fault), fault
