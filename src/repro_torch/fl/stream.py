"""Event-driven streaming RSU rounds, the counterpart of the JAX package's
`fl/stream.py`: the continuously-running, failure-tolerant round loop.

The synchronous `GenFVRunner` blocks every round on its slowest selected
vehicle's eq.-6/eq.-10 delay. `StreamEngine` instead runs GenFV rounds
against a deterministic **virtual wall-clock** (`repro_torch.obs.
VirtualClock`, never the host's clock; tests/test_torch_genfv_obs.py lints
the module for it): each selected vehicle's upload completes at its
`realized_arrivals(...)` instant on a seeded event queue, and the round
**commits when a configurable quorum of updates has arrived or the round
deadline expires**, whichever first.

Semantics per round, all driven through the shared
`GenFVRunner._execute_round` body so the two loops cannot drift:

* **Quorum commit**: with K selected and quorum q in (0, 1], the round
  commits at the ceil(q*K)-th eligible arrival if that lands within the
  planned straggler window t_bar. Updates arriving after the commit enter
  the in-flight queue with their realized due times and merge on arrival.
* **Retry/backoff**: an outage is a failed upload attempt: the vehicle
  backs off min(retry_backoff_s * 2^a, retry_backoff_cap_s) and re-prices
  the attempt through eq.-10 at its refreshed channel gain
  (`fl/faults.py::realized_arrivals`), up to `retry_budget` attempts. An
  exhausted vehicle's update never arrives; it counts as dropped without
  drawing from the RNG. A departed vehicle's retry is never scheduled.
* **Degradation ladder** (`StreamLog.rung`): rung 0 is the healthy
  quorum-in-window commit; rung 1 extends the deadline once by
  `deadline_slack` (only if stragglers are still inbound); rung 2 commits
  the partial quorum with the survivor weights renormalized; rung 3 skips
  the merge and carries the global forward.
* **Merge-on-arrival**: an in-flight update due inside the committing
  round's window folds into that round's aggregation with the
  rho * gamma^age staleness discount, like the synchronous stale merge;
  one due in the gap before a round starts is absorbed into the global at
  once (`GenFVServer.absorb`). Entries aged past `max_staleness` are
  dropped and counted (`stale_dropped`).

In-flight updates hold their parameter trees on the runner's device (the
full-width ResNet-18 is 44.7 MB in fp32; `max_staleness` bounds the
queue).

Determinism: the virtual clock, the round-keyed fault and retry streams
and the (due, seq)-ordered event queue make the schedule a pure function
of (RunConfig, StreamConfig); checkpoints resume mid-stream bitwise (the
in-flight uploads and the clock persist in the runner's checkpoint layout
under a `stream` block). On the card, bitwise holds under deterministic
cuDNN.

Parity: with quorum=1.0, cadence 0 and no faults every rung-0 commit lands
exactly on t_bar and `StreamEngine.run` is bitwise-equal to
`GenFVRunner.train` (tests/test_torch_genfv_stream.py pins it).
"""
from __future__ import annotations

import bisect
import dataclasses
from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.checkpoint import read_manifest, restore_tree, save_tree
from repro_torch.configs.base import StreamConfig
from repro_torch.core.selection import dropout_mask
from repro_torch.fl.faults import realized_arrivals
from repro_torch.fl.rounds import (GenFVRunner, RoundLog, RunResult,
                                   run_payload)
from repro_torch.obs import VirtualClock, log_line

__all__ = ["InFlight", "StreamEngine", "StreamLog"]


@dataclass
class InFlight:
    """One late upload traveling toward the RSU: enqueued by the committing
    round's `late_sink`, delivered (gap-absorb or window-merge) when the
    virtual clock passes `due`. `seq` breaks due-time ties deterministically
    (enqueue order), so the event queue is totally ordered."""
    due: float              # absolute virtual-clock arrival instant
    seq: int                # tie-break: global enqueue counter
    vid: int                # vehicle id (diagnostics)
    round: int              # round whose global the update descended from
    size: int               # |D_n|
    emd: float              # EMD_n
    rho: float              # data weight within its origin round
    retries: int            # backoff attempts consumed en route
    params: object          # the trained client model (tree, on device)

    def __lt__(self, other: "InFlight") -> bool:
        return (self.due, self.seq) < (other.due, other.seq)


@dataclass
class StreamLog:
    """Per-round streaming ledger, alongside the runner's `RoundLog`."""
    round: int
    t_start: float          # virtual clock at round start
    t_commit: float         # absolute commit instant
    rung: int               # degradation ladder: 0 healthy .. 3 skipped
    quorum_target: int      # ceil(quorum * K)
    arrived: int            # eligible uploads in by the commit
    merged_inflight: int    # in-flight updates folded into this commit
    gap_merged: int         # in-flight updates absorbed before round start
    stale_dropped: int      # in-flight updates aged past max_staleness
    late: int               # this round's uploads still in flight at commit
    retries: int            # backoff attempts consumed this round
    exhausted: int          # uploads whose retry budget ran out


class StreamEngine:
    """Asynchronous streaming engine over a `GenFVRunner`.

    Composes rather than subclasses: `begin_round`/`plan` are reused
    verbatim and execution goes through the runner's `_execute_round` with
    the late/skip partition and stale-merge set computed from the event
    simulation — the synchronous loop stays the semantic (and, at
    quorum=1.0 without faults, bitwise) reference.
    """

    def __init__(self, runner: GenFVRunner,
                 stream: StreamConfig | None = None):
        run = runner.run
        if not run.vectorized:
            raise ValueError(
                "StreamEngine requires vectorized=True (the sequential "
                "reference path stays synchronous-only)")
        if run.strategy == "aigc_only":
            raise ValueError(
                "strategy='aigc_only' has no vehicle uploads to stream")
        self.runner = runner
        # explicit arg > RunConfig.stream > defaults (which reproduce the
        # synchronous semantics: full quorum, no cadence)
        self.scfg = stream if stream is not None else (
            run.stream if run.stream is not None else StreamConfig())
        self.clock = VirtualClock()
        self.obs = runner.obs
        self.inflight: List[InFlight] = []   # kept sorted by (due, seq)
        self._seq = 0
        self.slogs: List[StreamLog] = []

    @property
    def now(self) -> float:
        return self.clock()

    # ------------------------------------------------------------------
    def _absorb_gap(self, t: int, t0: float) -> tuple:
        """Deliver every in-flight update due by `t0` (the round start):
        merge-on-arrival into the global with weight rho·gamma^age, or drop
        (counted) past max_staleness."""
        scfg = self.scfg
        server = self.runner.server
        merged = dropped = 0
        while self.inflight and self.inflight[0].due <= t0:
            e = self.inflight.pop(0)
            age = t - e.round
            if age > scfg.max_staleness:
                dropped += 1
                continue
            w = e.rho * scfg.staleness_discount ** age
            with self.obs.span("stream/arrival", round=t, vid=e.vid,
                               src=e.round, gap=1) as sp:
                sp.sync = server.absorb(e.params, w)
            merged += 1
        return merged, dropped

    def _commit_schedule(self, k: int, times: np.ndarray,
                         eligible: np.ndarray, t_bar: float) -> tuple:
        """The quorum/deadline decision: returns (rung, commit offset).

        Rung 0: the q-th eligible arrival lands within the planned window
        t_bar. Rung 1: quorum still completes within the slack-extended
        deadline (the one extension the ladder allows). Rung 2: quorum is
        unreachable — commit whatever arrived by the horizon (the extended
        deadline if stragglers were genuinely still inbound, else t_bar:
        waiting can't help when every missing upload is permanently gone).
        Rung 3: nothing arrived at all; skip the merge, carry the global."""
        scfg = self.scfg
        q = max(1, int(np.ceil(scfg.quorum * k)))
        ts = np.sort(times[eligible])
        d0 = float(t_bar)
        d1 = d0 * (1.0 + scfg.deadline_slack)
        n = ts.size
        if n >= q and ts[q - 1] <= d0:
            return 0, float(ts[q - 1]), q
        if n >= q and ts[q - 1] <= d1:
            return 1, float(ts[q - 1]), q
        inbound = n > 0 and float(ts[-1]) > d0
        horizon = d1 if inbound else d0
        arrived = int(np.searchsorted(ts, horizon, side="right"))
        return (2 if arrived else 3), horizon, q

    # ------------------------------------------------------------------
    def run_round(self, t: int) -> RoundLog:
        runner = self.runner
        cfg = runner.cfg
        scfg = self.scfg
        obs = self.obs
        t0 = self.clock()

        with obs.span("stream/tick", round=t, inflight=len(self.inflight)):
            gap_merged, dropped_gap = self._absorb_gap(t, t0)
            pending = runner.begin_round(t)
            plan = runner.plan(pending)
        k = len(plan.selected)
        spec = runner.faults.spec if runner.faults is not None else None

        if k == 0:
            # empty round: no uploads, no quorum — the slot still elapses
            log = runner._execute_round(
                pending, plan, rf=None, late_mask=None,
                t_round=plan.t_bar, survive=None, stale_models=[],
                stale_weights=[], stale_emds=[], stale_dropped=dropped_gap,
                guard_host=spec is not None, dt_floor=scfg.cadence_s)
            self.clock.advance(max(cfg.t_max, scfg.cadence_s))
            self.slogs.append(StreamLog(
                t, t0, t0, 0, 0, 0, 0, gap_merged, dropped_gap, 0, 0, 0))
            self._count(self.slogs[-1])
            return log

        # ---- realized arrival schedule (retry/backoff under outages) -----
        if spec is not None:
            rf = runner.faults.draw(t, k)
            with obs.span("stream/retry", round=t,
                          outages=int(rf.outage.sum())):
                times, retries, exhausted = realized_arrivals(
                    cfg, pending.fleet, plan, runner.model_bits, rf, spec, t,
                    retry_budget=scfg.retry_budget,
                    backoff_s=scfg.retry_backoff_s,
                    backoff_cap_s=scfg.retry_backoff_cap_s)
        else:
            rf = None
            times = (np.asarray(plan.t_cp, np.float64)
                     + np.asarray(plan.t_mu, np.float64))
            retries = np.zeros(k, np.int64)
            exhausted = np.zeros(k, bool)

        # coverage dropout against the PLANNED window (the RSU admitted the
        # schedule before any commit-time is known; matches the fault-free
        # synchronous rule exactly)
        survive = None
        alive = np.ones(k, bool)
        if runner.world is not None:
            survive = np.asarray(dropout_mask(
                cfg, pending.fleet, plan.selected,
                min(plan.t_bar, cfg.t_max)), bool)
            alive = survive.copy()
        has_data = np.array(
            [len(runner.client_data[pending.parts[j]][1]) >= 2
             for j in plan.selected], bool)
        # an upload can arrive iff its vehicle stays in coverage, has data
        # to train on, and its arrival time is finite (departed/exhausted
        # uploads are inf by construction)
        eligible = alive & has_data & np.isfinite(times)

        rung, c_rel, q = self._commit_schedule(k, times, eligible, plan.t_bar)
        arrived = int((eligible & (times <= c_rel)).sum())
        late_mask = eligible & (times > c_rel)
        skip_mask = exhausted if exhausted.any() else None

        # ---- in-flight updates landing inside this round's window --------
        stale_models, stale_weights, stale_emds = [], [], []
        merged_inflight = dropped_window = 0
        commit_abs = t0 + c_rel
        while self.inflight and self.inflight[0].due <= commit_abs:
            e = self.inflight.pop(0)
            age = t - e.round
            if age > scfg.max_staleness:
                dropped_window += 1
                continue
            with obs.span("stream/arrival", round=t, vid=e.vid,
                          src=e.round, gap=0):
                stale_models.append(e.params)
                stale_weights.append(e.size * scfg.staleness_discount ** age)
                stale_emds.append(e.emd)
            merged_inflight += 1

        # late uploads re-enter the event queue at their realized instants
        s_total = float(sum(pending.fleet[j].data_size
                            for j in plan.selected)) or 1.0

        def sink(entry, pos):
            self._seq += 1
            bisect.insort(self.inflight, InFlight(
                due=t0 + float(times[pos]), seq=self._seq, vid=entry.vid,
                round=t, size=entry.size, emd=entry.emd,
                rho=entry.size / s_total, retries=int(retries[pos]),
                params=entry.params))

        with obs.span("stream/commit", round=t, rung=rung, quorum=q,
                      arrived=arrived) as sp:
            log = runner._execute_round(
                pending, plan, rf=rf, late_mask=late_mask, t_round=c_rel,
                survive=survive, stale_models=stale_models,
                stale_weights=stale_weights, stale_emds=stale_emds,
                stale_dropped=dropped_gap + dropped_window, late_sink=sink,
                skip_mask=skip_mask, guard_host=spec is not None,
                dt_floor=scfg.cadence_s)
            sp.sync = runner.server.params

        # streaming cadence floors the clock advance; t_rsu deliberately
        # does NOT extend it — RSU generation pipelines with the next
        # round's label-sharing/selection phase
        self.clock.advance(max(c_rel, scfg.cadence_s))
        slog = StreamLog(t, t0, commit_abs, rung, q, arrived,
                         merged_inflight, gap_merged,
                         dropped_gap + dropped_window,
                         int(late_mask.sum()), int(retries.sum()),
                         int(exhausted.sum()))
        self.slogs.append(slog)
        self._count(slog)
        return log

    def _count(self, s: StreamLog) -> None:
        obs = self.obs
        if not obs.enabled:
            return
        obs.count("stream/rounds", 1)
        obs.count("stream/retries", s.retries)
        obs.count("stream/exhausted", s.exhausted)
        obs.count("stream/gap_merged", s.gap_merged)
        obs.count("stream/merged_inflight", s.merged_inflight)
        obs.count("stream/stale_dropped", s.stale_dropped)
        if s.rung:
            obs.count("stream/quorum_miss", 1)
        obs.observe("stream/rung", s.rung)
        obs.gauge("stream/inflight", len(self.inflight))

    # ------------------------------------------------------------------
    def run(self, verbose: bool = False, checkpoint_path: str | None = None,
            checkpoint_every: int = 1) -> RunResult:
        """Run (or resume) the remaining rounds on the virtual clock.
        Mirrors `GenFVRunner.train`, checkpointing the streaming state
        alongside the runner's."""
        runner = self.runner
        for t in range(runner.next_round, runner.run.rounds):
            log = self.run_round(t)
            if verbose:
                s = self.slogs[-1]
                log_line(
                    self.obs, "stream/round",
                    f"[stream] round {t:3d} rung={s.rung} "
                    f"q={s.arrived}/{s.quorum_target} "
                    f"now={self.now:8.2f}s inflight={len(self.inflight)} "
                    f"acc={log.accuracy:.3f}",
                    force=t == runner.run.rounds - 1,
                    round=t, accuracy=log.accuracy)
            if checkpoint_path is not None and \
                    (t + 1) % max(checkpoint_every, 1) == 0:
                with self.obs.span("round/checkpoint", round=t):
                    self.save_checkpoint(checkpoint_path)
        return RunResult(list(runner.logs))

    # ------------------------------------------------------------------
    # Mid-stream checkpointing: the runner's layout plus a `stream` block
    # (virtual clock, enqueue counter, streaming ledger, and the full
    # in-flight queue including each update's parameter tree). The manifest
    # carries `stream_cfg` so the synchronous loader refuses the file.
    # ------------------------------------------------------------------
    _SLOG_FLOAT_FIELDS = ("t_start", "t_commit")

    def _slogs_state(self) -> dict:
        return {f.name: np.asarray(
                    [getattr(s, f.name) for s in self.slogs],
                    np.float64 if f.name in self._SLOG_FLOAT_FIELDS
                    else np.int64)
                for f in dataclasses.fields(StreamLog)}

    def save_checkpoint(self, path: str) -> str:
        state = self.runner._checkpoint_state()
        state["stream"] = {
            "now": np.float64(self.clock()),
            "seq": np.int64(self._seq),
            "slogs": self._slogs_state(),
            "inflight": ({} if not self.inflight else {
                "due": np.asarray([e.due for e in self.inflight],
                                  np.float64),
                "seq": np.asarray([e.seq for e in self.inflight], np.int64),
                "vid": np.asarray([e.vid for e in self.inflight], np.int64),
                "round": np.asarray([e.round for e in self.inflight],
                                    np.int64),
                "size": np.asarray([e.size for e in self.inflight],
                                   np.int64),
                "emd": np.asarray([e.emd for e in self.inflight],
                                  np.float64),
                "rho": np.asarray([e.rho for e in self.inflight],
                                  np.float64),
                "retries": np.asarray([e.retries for e in self.inflight],
                                      np.int64),
                "params": [e.params for e in self.inflight],
            }),
        }
        meta = {"schema": self.runner.CKPT_SCHEMA,
                "run": run_payload(self.runner.run),
                "stream_cfg": self.scfg.to_payload()}
        return save_tree(path, state, metadata=meta)

    def load_checkpoint(self, path: str) -> int:
        """Restore a streaming snapshot into this (freshly constructed,
        identically configured) engine; returns the next round to run."""
        meta = read_manifest(path)["metadata"]
        self.runner._check_manifest(meta)
        if "stream_cfg" not in meta:
            raise ValueError(
                "checkpoint was written by the synchronous runner (no "
                "in-flight state); load it with GenFVRunner.load_checkpoint")
        if meta["stream_cfg"] != self.scfg.to_payload():
            raise ValueError(
                "checkpoint was written under a different streaming policy: "
                f"{meta['stream_cfg']} vs {self.scfg.to_payload()}")
        state = restore_tree(path)
        self.runner._restore_state(state)
        s = state["stream"]
        self.clock.t = float(s["now"])
        self._seq = int(s["seq"])
        slogs = s["slogs"]
        names = [f.name for f in dataclasses.fields(StreamLog)]
        self.slogs = [
            StreamLog(**{n: (float(slogs[n][i])
                             if n in self._SLOG_FLOAT_FIELDS
                             else int(slogs[n][i])) for n in names})
            for i in range(len(slogs["round"]))] if slogs else []
        inf = s["inflight"]
        self.inflight = []
        if inf:
            for i in range(len(inf["seq"])):
                self.inflight.append(InFlight(
                    due=float(inf["due"][i]), seq=int(inf["seq"][i]),
                    vid=int(inf["vid"][i]), round=int(inf["round"][i]),
                    size=int(inf["size"][i]), emd=float(inf["emd"][i]),
                    rho=float(inf["rho"][i]),
                    retries=int(inf["retries"][i]),
                    params=self.runner._to_device(inf["params"][i])))
        return self.runner.next_round
