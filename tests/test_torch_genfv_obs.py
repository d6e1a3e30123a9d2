"""The port's tracer, metrics registry and sinks (`repro_torch.obs`), the
counterparts of the JAX package's tests/test_obs.py contracts: an attached
tracer is bitwise-neutral, the fault-ledger metrics equal the RoundLogs,
the spans a run emits carry the reference runner's names and counts (the
port's own spans inside them, `PORT_SPANS`, fire where they should), spans
fence CUDA tensors only, traces are Perfetto-loadable and refuse open
spans, and the library has no bare print and no wall-clock read in the
round loop."""
from __future__ import annotations

import collections
import io
import json
import re
from pathlib import Path

import jax
import jax.experimental

# The JAX package imports `jax.experimental.enable_x64`, which jax 0.9
# no longer has; alias it before anything imports `repro`.
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)

import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import GenFVConfig as JGenFVConfig  # noqa: E402
from repro.fl.rounds import GenFVRunner as JRunner  # noqa: E402
from repro.fl.rounds import RunConfig as JRunConfig  # noqa: E402
from repro.obs import Obs as JObs  # noqa: E402
from repro_torch.configs.base import GenFVConfig  # noqa: E402
from repro_torch.core.planner import SYNC_EVERY  # noqa: E402
from repro_torch.fl.rounds import GenFVRunner, RunConfig, run_payload  # noqa: E402
from repro_torch.obs import (METRICS_SCHEMA, NULL_OBS, PORT_METRICS,  # noqa: E402
                             PORT_SPANS, MetricsRegistry, NullObs, Obs,
                             ProgressLogger, Stopwatch,
                             list_metrics_artifacts, load_metrics_artifact,
                             log_line, save_metrics_artifact, stopwatch)
from repro_torch.obs import trace as trace_mod  # noqa: E402
from repro_torch.obs.trace import _NULL_SPAN  # noqa: E402
from repro_torch.tree import FlatSpec  # noqa: E402

FAST = dict(rounds=3, train_size=400, test_size=64, scenario="rush_hour")
CFG = dict(batch_size=8, local_steps=2, num_vehicles=6)
SRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The test runner spreads files over worker processes on the same
    cores; torch's intra-op pool would take every core in each of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class FakeClock:
    """Deterministic monotone clock: every read advances by `step`."""

    def __init__(self, step: float = 1.0):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


# ---------------------------------------------------------------------------
# Registry, stopwatch, progress lines
# ---------------------------------------------------------------------------
def test_registry_counters_gauges_dists_and_merge():
    m = MetricsRegistry()
    m.count("a")
    m.count("a", 2)
    m.count("a", 1, phase="x")
    m.gauge("g", 5.0)
    m.gauge("g", 7.0)
    for v in (3.0, 1.0, 2.0):
        m.observe("d", v)
    assert m.counter_value("a") == 3 and m.counter_value("a", phase="x") == 1
    assert m.counter_value("missing") == 0
    assert m.gauge_value("g") == 7.0 and m.gauge_value("missing", default=-1) == -1
    (d,) = m.payload()["dists"]
    assert d == {"name": "d", "tags": {}, "n": 3, "sum": 6.0, "min": 1.0, "max": 3.0}
    other = MetricsRegistry()
    other.count("a", 4)
    other.gauge("g", 9.0)
    other.observe("d", 5.0)
    m.merge(other)
    assert m.counter_value("a") == 7 and m.gauge_value("g") == 9.0
    (d,) = m.payload()["dists"]
    assert (d["n"], d["sum"], d["min"], d["max"]) == (4, 11.0, 1.0, 5.0)
    assert [r["name"] for r in json.loads(json.dumps(m.payload()))["counters"]] == ["a", "a"]


def test_stopwatch_and_progress_logger(capsys):
    clk = FakeClock(step=1.0)
    with stopwatch(clock=clk) as sw:
        live = sw.elapsed_s
    assert (live, sw.elapsed_s, sw.elapsed_s) == (1.0, 2.0, 2.0)
    assert isinstance(sw, Stopwatch)
    out = io.StringIO()
    pl = ProgressLogger(min_interval_s=0.1, clock=FakeClock(step=0.01), out=out)
    wrote = [pl.emit("k", f"line{i}") for i in range(5)]
    assert wrote[0] and not any(wrote[1:])
    assert pl.emit("other", "x") and pl.emit("k", "final", force=True)
    assert out.getvalue().splitlines() == ["line0", "x", "final"]
    obs = Obs(clock=FakeClock())
    log_line(obs, "train/x", "round 0 acc=0.1", force=True, round=0, accuracy=0.1)
    (ev,) = obs.events
    assert ev["name"] == "log" and ev["tags"]["accuracy"] == 0.1
    log_line(NULL_OBS, "train/x", "null path ok", force=True)
    text = capsys.readouterr().out
    assert "round 0 acc=0.1" in text and "null path ok" in text


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------
def test_span_tagging_nesting_and_views():
    obs = Obs(clock=FakeClock())
    for _ in range(2):
        with obs.span("phase", key=4):
            pass
    with obs.span("phase", key=8):
        pass
    with obs.span("outer"):
        assert obs.open_spans == 1
        with obs.span("inner"):
            assert obs.open_spans == 2
    assert obs.open_spans == 0
    assert [(e["name"], e["stage"]) for e in obs.events] == [
        ("phase", "compile"), ("phase", "execute"), ("phase", "compile"),
        ("inner", "execute"), ("outer", "execute")]
    cell = obs.tagged(cell=3)
    with cell.span("round/plan", round=1):
        pass
    cell.count("planner/rounds")
    cell.tagged(round=9).gauge("g", 1.0)
    assert obs.events[-1]["tags"] == {"cell": 3, "round": 1}
    assert obs.metrics.counter_value("planner/rounds", cell=3) == 1
    assert obs.metrics.gauge_value("g", cell=3, round=9) == 1.0


def test_spans_never_sync_without_a_card(monkeypatch):
    """A span's fence synchronises only CUDA devices: tensors on the CPU
    (or any other device) and the null path never call into CUDA. The
    fence on the card is exercised by chip_smoke.py's traced rounds."""
    calls = []
    monkeypatch.setattr(trace_mod.torch.cuda, "synchronize", calls.append)
    obs = Obs(clock=FakeClock())
    with obs.span("cpu") as sp:
        sp.sync = {"a": torch.zeros(2), "b": [torch.ones(1), 3.0], "c": (torch.zeros(1, device="meta"),)}
    with NULL_OBS.span("null") as sp:
        sp.sync = torch.zeros(1)
    trace_mod.sync_devices([torch.zeros(3), None, "x"])
    assert calls == [] and [e["name"] for e in obs.events] == ["cpu"]


def test_null_obs_surface():
    assert isinstance(NULL_OBS, NullObs) and not NULL_OBS.enabled
    sp = NULL_OBS.span("anything", key=1, tag="x")
    assert sp is _NULL_SPAN
    NULL_OBS.count("c", 5)
    NULL_OBS.gauge("g", 1.0)
    NULL_OBS.observe("d", 2.0)
    NULL_OBS.event("e", k=1)
    assert NULL_OBS.tagged(cell=1) is NULL_OBS


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------
def _sample_obs() -> Obs:
    obs = Obs(clock=FakeClock(), meta={"spec": "unit"})
    with obs.span("round/plan", key=4, round=0):
        with obs.span("round/select", round=0):
            pass
    obs.event("log", text="hello")
    with obs.span("round/plan", key=4, round=1, cell=2):
        pass
    obs.count("planner/rounds", 2)
    obs.gauge("fleet/bucket", 4)
    return obs


def test_metrics_artifact_roundtrip_and_guard(tmp_path):
    obs = _sample_obs()
    path = obs.save_metrics("unit", directory=str(tmp_path))
    assert Path(path).name == "torch_unit.metrics.json"
    assert list_metrics_artifacts(str(tmp_path)) == [path]
    (tmp_path / "unit.metrics.json").write_text("{}")     # the JAX package's name
    assert list_metrics_artifacts(str(tmp_path)) == [path]
    doc = load_metrics_artifact(path)
    assert doc["schema"] == METRICS_SCHEMA and doc["meta"] == {"spec": "unit"}
    assert doc["open_spans"] == 0 and doc["events"] == 4
    assert {"torch", "cuda_device", "device_count", "platform"} <= set(doc["host"])
    assert doc["host"]["torch"] == torch.__version__
    assert any(d["name"] == "span/round/plan" for d in doc["dists"])
    bad = tmp_path / "x.metrics.json"
    bad.write_text(json.dumps({"schema": "repro.obs/metrics/v1"}))
    with pytest.raises(ValueError, match="not a"):
        load_metrics_artifact(str(bad))
    with pytest.raises(ValueError, match="schema"):
        save_metrics_artifact({"schema": "wrong"}, "x", directory=str(tmp_path))


def test_jsonl_and_trace_schema(tmp_path):
    obs = _sample_obs()
    lines = [json.loads(l) for l in open(obs.write_jsonl(str(tmp_path / "e.jsonl")))]
    assert lines[0]["schema"] == "repro_torch.obs/events/v1"
    assert len(lines) == 1 + len(obs.events) and {l["ph"] for l in lines[1:]} == {"X", "i"}
    doc = json.load(open(obs.write_trace(str(tmp_path / "trace.json"))))
    assert doc["otherData"]["schema"] == "repro_torch.obs/trace/v1"
    evs = doc["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert all(e["ts"] >= 0 for e in evs) and all(e["dur"] >= 0 for e in xs)
    ends = [e["ts"] + e["dur"] for e in xs]
    assert ends == sorted(ends)
    assert all(e["s"] == "t" for e in evs if e["ph"] == "i")
    assert {e["tid"] for e in xs} == {0, 3}
    assert {e["args"]["stage"] for e in xs} == {"compile", "execute"}


def test_trace_refuses_open_spans(tmp_path):
    obs = Obs(clock=FakeClock())
    obs.span("dangling").__enter__()
    with pytest.raises(ValueError, match="open"):
        obs.write_trace(str(tmp_path / "trace.json"))


# ---------------------------------------------------------------------------
# Runner integration
# ---------------------------------------------------------------------------
def _run_cfg(planner, faults):
    return RunConfig(planner=planner, faults=faults, **FAST)


def _runner(run, **kw):
    return GenFVRunner(run, fl_cfg=GenFVConfig(**CFG), device="cpu", **kw)


@pytest.mark.parametrize("planner", ["torch", "numpy"])
@pytest.mark.parametrize("faults", [None, "mixed_stress"])
def test_tracer_is_bitwise_neutral(planner, faults):
    obs = Obs(meta={"planner": planner})
    traced_runner = _runner(_run_cfg(planner, faults), obs=obs)
    traced = traced_runner.train()
    plain_runner = _runner(_run_cfg(planner, faults))
    plain = plain_runner.train()
    assert plain.logs == traced.logs
    flat = [FlatSpec(r.server.params).flatten(r.server.params)
            for r in (plain_runner, traced_runner)]
    assert torch.equal(*flat)
    assert obs.open_spans == 0
    m = obs.metrics
    assert m.counter_value("planner/rounds", planner=planner) == FAST["rounds"]
    assert m.counter_value("planner/converged", planner=planner) == \
        sum(l.planner_converged for l in traced.logs)
    for key in ("late", "rejected", "stale_merged", "stale_dropped", "dropped"):
        assert m.counter_value(f"faults/{key}") == traced.curve(key).sum(), key
    d = next(d for d in m.payload()["dists"] if d["name"] == "round/t_round")
    assert d["n"] == FAST["rounds"]
    assert m.gauge_value("world/population") is not None
    if faults:
        assert traced.curve("rejected").sum() + traced.curve("late").sum() > 0


def test_runconfig_obs_is_not_configuration():
    plain, traced = RunConfig(**FAST), RunConfig(obs=Obs(clock=FakeClock()), **FAST)
    assert plain == traced
    payload = run_payload(traced)
    assert "obs" not in payload and json.loads(json.dumps(payload)) == payload


def _span_counts(obs):
    return collections.Counter((e["name"], e.get("stage")) for e in obs.events
                               if e["ph"] == "X")


def _split_port_spans(counts):
    """(the counts of the spans the reference opens too, of the port's own
    spans by name)."""
    ref, port = collections.Counter(), collections.Counter()
    for (name, stage), n in counts.items():
        if name in PORT_SPANS:
            port[name] += n
        else:
            ref[(name, stage)] += n
    return ref, port


def _fleet_steps(obs):
    """Rounds that ran the vectorized fleet step (`fleet/pad_waste` is
    observed once in each)."""
    dists = {d["name"]: d for d in obs.metrics.payload()["dists"]}
    return dists["fleet/pad_waste"]["n"] if "fleet/pad_waste" in dists else 0


def _metric_names(obs):
    p = obs.metrics.payload()
    return {(c["name"], tuple(sorted(c["tags"]))) for c in p["counters"] + p["gauges"]}


def test_span_names_equal_the_reference_runner(tmp_path):
    """The same faulted run (numpy planner, so both plan alike) traced in
    both packages emits the same spans, each as often and with the same
    first-call stage; checkpoints included."""
    kw = dict(planner="numpy", faults="mixed_stress", **FAST)
    jobs, tobs = JObs(), Obs()
    jres = JRunner(JRunConfig(**kw), fl_cfg=JGenFVConfig(**CFG), obs=jobs).train(
        checkpoint_path=str(tmp_path / "j.npz"))
    tres = _runner(RunConfig(**kw), obs=tobs).train(checkpoint_path=str(tmp_path / "t.npz"))
    assert [(l.selected, l.late, l.rejected, l.dropped) for l in jres.logs] == \
        [(l.selected, l.late, l.rejected, l.dropped) for l in tres.logs]
    want, got = _span_counts(jobs), _span_counts(tobs)
    assert ("round/checkpoint", "execute") in got and ("round/aggregate", "compile") in got
    # the port's own spans time inside layers the reference times only from
    # outside: set apart, the reference's spans match one for one
    got, port = _split_port_spans(got)
    assert got == want
    fleet_steps = _fleet_steps(tobs)
    assert 0 < fleet_steps <= FAST["rounds"]
    assert port == {"round/generate/train": FAST["rounds"],
                    "round/aggregate/upload": fleet_steps,
                    "round/aggregate/sgd": fleet_steps,
                    "round/aggregate/eq4": fleet_steps}
    metric_names = {m for m in _metric_names(tobs) if m[0] not in PORT_METRICS}
    assert metric_names == _metric_names(jobs)


def test_ddpm_span_names_equal_the_reference_runner(monkeypatch, tmp_path):
    """The same ddpm run (the tiny dataplane of
    tests/test_torch_genfv_ddpm_rounds.py, numpy planner) traced in both
    packages emits the same spans, the generator's `round/generate/sample`
    included, each as often and with the same first-call stage, and the
    same `gen/images` and `gen/pad_waste` metrics."""
    import repro.gen.service as j_service
    import repro_torch.gen.service as gen_service
    from test_torch_genfv_ddpm_rounds import STEPS, TINY_BUDGET, seed_calibrations
    for k, v in TINY_BUDGET.items():
        monkeypatch.setattr(gen_service, k, v)
        monkeypatch.setattr(j_service, k, v)
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    seed_calibrations()
    kw = dict(planner="numpy", generator="ddpm", sampler_steps=STEPS, **FAST)
    jobs, tobs = JObs(), Obs()
    jres = JRunner(JRunConfig(**kw), fl_cfg=JGenFVConfig(**CFG), obs=jobs).train()
    tres = _runner(RunConfig(**kw), obs=tobs).train()
    assert [l.b_gen for l in jres.logs] == [l.b_gen for l in tres.logs]
    want, got = _span_counts(jobs), _span_counts(tobs)
    assert got[("round/generate/sample", "compile")] >= 1
    assert sum(n for (name, _), n in got.items() if name == "round/generate/sample") == \
        sum(1 for l in tres.logs if l.b_gen > 0)
    got, port = _split_port_spans(got)
    assert got == want
    fleet_steps = _fleet_steps(tobs)
    assert port == {"round/generate/train": FAST["rounds"],
                    "round/aggregate/upload": fleet_steps,
                    "round/aggregate/sgd": fleet_steps,
                    "round/aggregate/eq4": fleet_steps}
    for obs in (jobs, tobs):
        assert obs.metrics.counter_value("gen/images") == sum(l.b_gen for l in tres.logs)
    dists = [{d["name"]: d for d in o.metrics.payload()["dists"]}["gen/pad_waste"]
             for o in (jobs, tobs)]
    assert dists[0] == dists[1]


#: the span each of the port's own spans opens inside
PORT_PARENT = {"round/plan/bandwidth": "round/plan", "round/plan/power": "round/plan",
               "round/plan/generation": "round/plan", "round/plan/ledger": "round/plan",
               "round/generate/train": "round/generate",
               "round/aggregate/upload": "round/aggregate",
               "round/aggregate/sgd": "round/aggregate",
               "round/aggregate/eq4": "round/aggregate"}


@pytest.mark.parametrize("strategy", ["genfv", "fedavg"])
def test_port_spans_nest_in_the_round(strategy):
    """In vectorized rounds with the device planner, each of the port's
    spans opens inside its parent span: the planner's three once a BCD
    iteration and the ledger's once a plan, omega_a's once a generating
    round, the fleet step's three once a fleet step. The planner's steps
    reach the registry by part, in whole chunks."""
    assert set(PORT_PARENT) == set(PORT_SPANS)
    obs = Obs(clock=FakeClock())
    res = _runner(RunConfig(strategy=strategy, **FAST), obs=obs).train()
    assert obs.open_spans == 0
    spans = [e for e in obs.events if e["ph"] == "X"]
    for e in spans:
        if e["name"] in PORT_PARENT:
            assert any(p["name"] == PORT_PARENT[e["name"]] and p["ts"] < e["ts"]
                       and e["ts"] + e["dur"] < p["ts"] + p["dur"] for p in spans), e
    count = collections.Counter(e["name"] for e in spans)
    planned = [l for l in res.logs if l.bcd_iters]
    iters = sum(l.bcd_iters for l in planned)
    fleet_steps = _fleet_steps(obs)
    assert planned and fleet_steps > 0
    assert {n: count[n] for n in PORT_SPANS} == {
        "round/plan/bandwidth": iters, "round/plan/power": iters,
        "round/plan/generation": iters, "round/plan/ledger": len(planned),
        "round/generate/train": FAST["rounds"] if strategy == "genfv" else 0,
        "round/aggregate/upload": fleet_steps, "round/aggregate/sgd": fleet_steps,
        "round/aggregate/eq4": fleet_steps}
    steps = {part: obs.metrics.counter_value("planner/steps", part=part)
             for part in ("bandwidth", "bandwidth_redo", "power")}
    assert steps["bandwidth"] >= SYNC_EVERY * iters and steps["power"] >= SYNC_EVERY * iters
    assert all(n % SYNC_EVERY == 0 for n in steps.values()), steps
    assert {m[0] for m in _metric_names(obs)} >= set(PORT_METRICS)


# ---------------------------------------------------------------------------
# Library hygiene
# ---------------------------------------------------------------------------
_PRINT_RE = re.compile(r"(?<![\w.])print\(")
_WALLCLOCK_RE = re.compile(r"(?<![\w.])time\.(time|monotonic)\(")


def _offenders(root, pattern):
    out = []
    for path in sorted(root.rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if pattern.search(line.split("#", 1)[0]):
                out.append(f"{path.relative_to(SRC)}:{i}")
    return out


def test_no_bare_print_in_library():
    """Progress goes through `log_line` / `ProgressLogger`, never print."""
    assert len(list(SRC.rglob("*.py"))) > 30
    offenders = _offenders(SRC, _PRINT_RE)
    assert not offenders, f"bare print( in src/repro_torch: {offenders}"


def test_no_wall_clock_in_the_round_loop():
    """The round loop (fl/, the streaming engine fl/stream.py among it),
    the experiment layer (exp/) and the serving engine read no wall clock
    (clocks are injected: `Obs(clock=...)`, `VirtualClock`)."""
    assert (SRC / "fl" / "stream.py").exists() and (SRC / "exp" / "sweep.py").exists()
    offenders = [o for sub in ("fl", "exp", "serve") for o in _offenders(SRC / sub, _WALLCLOCK_RE)]
    assert not offenders, offenders
