"""Contracts of the JAX package's fault and checkpoint tests
(tests/test_faults.py), held inside the port on the CPU: a benign fault
spec is bitwise the fault-free run, a faulted run replays bitwise, the
vectorized and sequential paths agree under poisoning, an all-poisoned
round falls back to the round-start global, golden resume is bitwise for
both planners with and without faults, checkpoint writes are atomic, and a
checkpoint from another RunConfig (or a streaming engine) is refused. The
checkpoint layout is checked against the JAX package's `save_tree`."""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.checkpoint.io as ckpt_io
from repro.checkpoint import read_manifest as j_read_manifest
from repro.checkpoint import save_tree as j_save_tree
from repro_torch.checkpoint import (read_manifest, restore_into, restore_tree,
                                    save_tree)
from repro_torch.configs.base import GenFVConfig
from repro_torch.core.emd import tree_finite
from repro_torch.fl.faults import FaultSpec
from repro_torch.fl.rounds import GenFVRunner, RunConfig, run_payload
from repro_torch.tree import FlatSpec, tree_leaves

FAST = dict(rounds=3, train_size=400, test_size=64)
FAST_CFG = GenFVConfig(batch_size=8, local_steps=2, num_vehicles=6)
LOG_KEYS = ("selected", "dropped", "late", "rejected", "stale_merged",
            "t_bar", "t_round", "b_gen", "kappa2", "emd_bar", "loss",
            "accuracy")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The test runner spreads files over worker processes on the same
    cores; torch's intra-op pool would take every core in each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _runner(run, **kw):
    return GenFVRunner(run, fl_cfg=FAST_CFG, device="cpu", **kw)


def _flat(params):
    return FlatSpec(params).flatten(params)


def _assert_same(res_a, res_b, keys=LOG_KEYS):
    for k in keys:
        np.testing.assert_array_equal(res_a.curve(k), res_b.curve(k), err_msg=k)


# ---------------------------------------------------------------------------
# Faults inside the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vectorized", [True, False])
def test_benign_spec_is_the_fault_free_run(vectorized):
    run = RunConfig(scenario="rush_hour", vectorized=vectorized, **FAST)
    plain, benign = _runner(run), _runner(run, faults=FaultSpec(seed=1))
    a, b = plain.train(), benign.train()
    assert a.logs == b.logs
    assert torch.equal(_flat(plain.server.params), _flat(benign.server.params))


def test_faulted_run_replays_bitwise():
    run = RunConfig(scenario="rush_hour", faults="mixed_stress", **FAST)
    a, b = _runner(run), _runner(run)
    ra, rb = a.train(), b.train()
    assert ra.logs == rb.logs
    assert sum(l.late + l.rejected + l.dropped for l in ra.logs) > 0
    assert torch.equal(_flat(a.server.params), _flat(b.server.params))


def test_poison_minority_vectorized_equals_sequential():
    """The guarded fleet step and the sequential path's host guard reject
    the same updates and renormalise the same survivors."""
    run = RunConfig(scenario="rush_hour", faults="poison_minority", **FAST)
    a = _runner(run).train()
    b = _runner(dataclasses.replace(run, vectorized=False)).train()
    assert a.curve("rejected").sum() > 0
    _assert_same(a, b, keys=("selected", "dropped", "late", "rejected",
                             "stale_merged", "accuracy"))


@pytest.mark.parametrize("vectorized", [True, False])
def test_all_poisoned_round_falls_back(vectorized):
    """poison_prob=1: every upload is rejected and the federated mass goes
    to the round-start global; with fl_only (no omega_a) the global is
    unchanged up to float32 rounding of the weights' sum."""
    spec = FaultSpec(seed=4, poison_prob=1.0)
    run = RunConfig(strategy="fl_only", scenario="rush_hour",
                    vectorized=vectorized, **FAST)
    r = _runner(run, faults=spec)
    for t in range(FAST["rounds"]):
        start = _flat(r.server.params).clone()
        log = r.run_round(t)
        assert log.rejected == log.selected - log.late > 0
        assert log.loss == 0.0 and 0.0 <= log.accuracy <= 1.0
        torch.testing.assert_close(_flat(r.server.params), start, rtol=1e-6, atol=0)
    assert tree_finite(r.server.params)
    g = _runner(dataclasses.replace(run, strategy="genfv"), faults=spec).train()
    assert all(l.rejected == l.selected - l.late for l in g.logs)


def test_late_updates_merge_one_round_later():
    """Everyone straggles past the deadline: every buffered update merges
    in the next round, and a late round holds the RSU open until the
    deadline."""
    spec = FaultSpec(seed=3, straggler_prob=1.0, straggler_slowdown=50.0,
                     deadline_slack=0.05)
    res = _runner(RunConfig(scenario="rush_hour", **dict(FAST, rounds=4)),
                  faults=spec).train()
    late, merged = res.curve("late"), res.curve("stale_merged")
    assert late.sum() > 0 and merged[0] == 0
    np.testing.assert_array_equal(merged[1:], late[:-1])
    for log in res.logs:
        if log.late:
            assert log.t_round == pytest.approx(log.t_bar * (1 + spec.deadline_slack))
        assert np.isfinite(log.loss)
    spec0 = dataclasses.replace(spec, max_staleness=0)
    res0 = _runner(RunConfig(scenario="rush_hour", **FAST), faults=spec0).train()
    assert res0.curve("stale_merged").sum() == 0 and res0.curve("stale_dropped").sum() > 0


# ---------------------------------------------------------------------------
# Golden resume
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("planner", ["torch", "numpy"])
@pytest.mark.parametrize("faults", [None, "mixed_stress"])
def test_golden_resume(planner, faults, tmp_path):
    run = RunConfig(scenario="rush_hour", planner=planner, faults=faults, **FAST)
    full_runner = _runner(run)
    full = full_runner.train()
    path = str(tmp_path / "runner.npz")
    interrupted = _runner(run)
    for t in range(2):
        interrupted.run_round(t)
    interrupted.save_checkpoint(path)
    resumed = _runner(run)
    assert resumed.load_checkpoint(path) == 2
    assert all(x.device.type == "cpu" for x in tree_leaves(resumed.server.params))
    res = resumed.train()
    assert len(res.logs) == FAST["rounds"]
    assert full.logs == res.logs
    assert torch.equal(_flat(full_runner.server.params), _flat(resumed.server.params))


def test_train_checkpoints_and_resumes_with_stale_entries(tmp_path):
    """train(checkpoint_path=...) writes every `checkpoint_every` rounds; a
    checkpoint taken while late updates sit in the stale buffer resumes
    bitwise."""
    spec = FaultSpec(seed=3, straggler_prob=1.0, straggler_slowdown=50.0,
                     deadline_slack=0.05)
    run = RunConfig(scenario="rush_hour", **FAST)
    path = str(tmp_path / "every.npz")
    full = _runner(run, faults=spec).train(checkpoint_path=path, checkpoint_every=2)
    manifest = read_manifest(path)
    assert manifest["metadata"]["schema"] == GenFVRunner.CKPT_SCHEMA
    assert any(k.startswith("stale/params/0/") for k in manifest["keys"])
    resumed = _runner(run, faults=spec)
    assert resumed.load_checkpoint(path) == 2    # written after round 1 only
    assert len(resumed.stale) == full.logs[1].late > 0
    assert resumed.train().logs == full.logs


def test_checkpoint_refuses_foreign_runconfig_and_streaming(tmp_path):
    run = RunConfig(scenario="rush_hour", **FAST)
    r = _runner(run)
    r.run_round(0)
    path = r.save_checkpoint(str(tmp_path / "runner"))
    assert path.endswith("runner.npz")
    with pytest.raises(ValueError, match="different RunConfig"):
        _runner(dataclasses.replace(run, strategy="fedavg")).load_checkpoint(path)
    meta = {"schema": GenFVRunner.CKPT_SCHEMA, "run": run_payload(run), "stream_cfg": {}}
    stream = save_tree(str(tmp_path / "stream.npz"), r._checkpoint_state(), metadata=meta)
    with pytest.raises(ValueError, match="streaming"):
        _runner(run).load_checkpoint(stream)
    bad = save_tree(str(tmp_path / "bad.npz"), {"a": np.zeros(1)},
                    metadata={"schema": "repro.fl/runner-ckpt/v4", "run": run_payload(run)})
    with pytest.raises(ValueError, match="schema"):
        _runner(run).load_checkpoint(bad)
    fresh = _runner(run)
    assert fresh.load_checkpoint(path) == 1 and fresh.logs == r.logs


def test_checkpoint_atomic_on_partial_write(tmp_path, monkeypatch):
    """A crash mid-save leaves the previous checkpoint intact and no
    temporary file behind."""
    path = str(tmp_path / "ckpt.npz")
    final = save_tree(path, {"a": np.arange(4.0)}, metadata={"step": 1})

    def torn_savez(f, **arrays):
        f.write(b"PK\x03\x04 half a zip")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_io.np, "savez", torn_savez)
    with pytest.raises(OSError, match="disk full"):
        save_tree(path, {"a": np.zeros(4)}, metadata={"step": 2})
    monkeypatch.undo()
    assert read_manifest(final)["metadata"] == {"step": 1}
    np.testing.assert_array_equal(restore_tree(final)["a"], np.arange(4.0))
    assert [p.name for p in tmp_path.iterdir()] == ["ckpt.npz"]


def test_checkpoint_layout_equals_the_reference(tmp_path):
    """The same tree of numpy leaves gets the JAX package's keys, skeleton
    and metadata; tensors are written as their host arrays and come back
    into a template on its device."""
    rng = np.random.default_rng(0)
    tree = {"zeta": [rng.normal(size=(2, 3)).astype(np.float32), np.int64(7)],
            "alpha": {"b": np.arange(3), "a": (np.float64(1.5), np.zeros((1, 2)))},
            "empty": {}}
    meta = {"step": np.int64(3), "lr": np.float32(0.5), "ok": np.bool_(True)}
    mine = read_manifest(save_tree(str(tmp_path / "port"), tree, metadata=meta))
    ref = j_read_manifest(j_save_tree(str(tmp_path / "ref"), tree, metadata=meta))
    assert mine["keys"] == ref["keys"]
    assert mine["structure"] == ref["structure"] and mine["metadata"] == ref["metadata"]
    back = restore_tree(str(tmp_path / "port.npz"))
    assert isinstance(back["alpha"]["a"], tuple) and back["empty"] == {}
    np.testing.assert_array_equal(back["zeta"][0], tree["zeta"][0])
    params = {"w": torch.randn(3, 2), "b": [torch.arange(4.0)]}
    save_tree(str(tmp_path / "t.npz"), params)
    into = restore_into({"w": torch.zeros(3, 2), "b": [torch.zeros(4)]},
                        str(tmp_path / "t.npz"))
    assert torch.equal(into["w"], params["w"]) and torch.equal(into["b"][0], params["b"][0])
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_into({"w": torch.zeros(2, 3), "b": [torch.zeros(4)]}, str(tmp_path / "t.npz"))
    with pytest.raises(ValueError, match="leaf count"):
        restore_into({"w": torch.zeros(3, 2)}, str(tmp_path / "t.npz"))
