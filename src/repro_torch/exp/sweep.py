"""Batched sweep execution, the counterpart of the JAX package's
`exp/sweep.py`: one `Sweep` drives every cell of an `ExperimentSpec` in
round-lockstep on one device ("cuda" unless the caller asks for another).

What is shared across cells (and why it is exact, not approximate):

* **Dataset builds** — `make_image_dataset(name, n, seed)` is a pure
  function of its arguments, so cells that agree on them get the same
  arrays from one build (a 5-strategy sweep builds its train set once, not
  five times).
* **FleetEngines** — one engine per (CNN config, local_steps, batch_size)
  model shape. The engine is stateless across `run()` calls.
* **SUBP2-4 planning** — each round, all torch-planner cells that agree on
  (GenFVConfig, model_bits, generation service) are planned in ONE
  `plan_rounds_batched` dispatch on the sweep's device. The planner's
  done-guarded batched loops make the batch bitwise-identical to per-cell
  planning, which is what the sweep/single parity test pins. Cells with
  different measured t_image (ddpm cells at different `sampler_steps`)
  price eq. 48 differently and never share a dispatch. numpy-planner
  cells plan one by one on the host (the pinned paper-math reference).

**Never shared: model state.** Every cell owns its runner, global model,
RNG stream, world and test set on the device (the dataset cache shares
only the host arrays) — a sweep is N independent experiments that happen
to be executed well, and `Sweep.run()` reproduces per-cell
`GenFVRunner.train()` bitwise (tests/test_torch_genfv_exp.py; on the card
under deterministic cuDNN).

`SweepResult` is struct-of-arrays: one `[n_cells, max_rounds]` float
tensor per RoundLog metric (NaN-padded where a cell ran fewer rounds),
with `curve()/select()/final()/to_json()/save()` and the versioned
artifact schema of `repro_torch.exp.artifacts`.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import GenFVConfig
from repro_torch.configs.genfv_cifar import cnn_config
from repro_torch.core.two_scale import plan_rounds_batched
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.exp.artifacts import load_artifact, save_artifact, schema_tag
from repro_torch.exp.spec import Cell, ExperimentSpec
from repro_torch.fl.fleet import FleetEngine
from repro_torch.fl.rounds import CLIENT_LR, GenFVRunner, run_payload
from repro_torch.models.api import resolve_device
from repro_torch.obs import NULL_OBS, log_line

SWEEP_SCHEMA = schema_tag("sweep")               # repro_torch.exp/sweep/v1

#: RoundLog fields captured into the metric tensors.
METRIC_KEYS = ("selected", "dropped", "t_bar", "b_gen", "kappa2",
               "emd_bar", "loss", "accuracy",
               # fault-tolerance ledger (fl/faults.py; zero on clean runs)
               "late", "rejected", "stale_merged", "t_round",
               # planner diagnostics (core/planner.py)
               "bcd_iters", "planner_converged")


class _DatasetCache:
    """Exact memo of `make_image_dataset`: identical (name, n, seed) calls
    return the same arrays (read-only consumers: partitioning copies)."""

    def __init__(self):
        self._cache: Dict[tuple, tuple] = {}
        self.builds = 0
        self.hits = 0

    def __call__(self, name: str, n: int, seed: int = 0):
        key = (name, int(n), int(seed))
        if key not in self._cache:
            self._cache[key] = make_image_dataset(name, n, seed=seed)
            self.builds += 1
        else:
            self.hits += 1
        return self._cache[key]


class Sweep:
    """Executor for an `ExperimentSpec`.

    Parameters
    ----------
    spec: the grid to run.
    fl_cfg: shared GenFVConfig for every cell (scenario overlays still
        apply per cell). None keeps the runner default
        (`GenFVConfig(dirichlet_alpha=cell.alpha)`).
    generator_factory: optional `cell -> generator` hook for the cells'
        AIGC service; None lets each runner build its own from
        `cell.run.generator`.
    obs: a `repro_torch.obs.Obs` tracer shared by the sweep and every
        cell's runner (each runner gets a cell-tagged view). None keeps the
        null path; either way the executed rounds are bitwise-identical.
    device: where every cell's model, fleet step and torch planner run
        ("cuda" unless the caller asks for another; raises without CUDA).
    """

    def __init__(self, spec: ExperimentSpec,
                 fl_cfg: GenFVConfig | None = None,
                 generator_factory: Optional[Callable[[Cell], Any]] = None,
                 verbose: bool = False, obs=None, device="cuda"):
        self.device = resolve_device(device)
        self.spec = spec
        self.fl_cfg = fl_cfg
        self.generator_factory = generator_factory
        self.verbose = verbose
        self.obs = obs if obs is not None else NULL_OBS
        self._datasets = _DatasetCache()
        self._engines: Dict[tuple, FleetEngine] = {}

    # ------------------------------------------------------------------
    def _make_runner(self, cell: Cell) -> GenFVRunner:
        run = cell.run
        fl = self.fl_cfg or GenFVConfig(dirichlet_alpha=run.alpha)
        cnn = cnn_config(run.dataset, run.width_mult)
        # scenario overlays never touch local_steps/batch_size
        # (sim/scenarios.py::_CFG_OVERRIDES), so the engine key is known
        # before the runner applies them
        key = (cnn, fl.local_steps, fl.batch_size)
        engine = self._engines.get(key)
        if engine is None:
            engine = FleetEngine(cnn, fl.local_steps, fl.batch_size,
                                 lr=CLIENT_LR)
            self._engines[key] = engine
        # without a factory each runner builds its own AIGC service from
        # `run.generator`: the oracle, or for "ddpm" cells
        # `make_ddpm_generator(..., device=)` at the cell's `sampler_steps`,
        # priced with its measured t_image
        gen = self.generator_factory(cell) if self.generator_factory is not None else None
        return GenFVRunner(run, fl_cfg=fl, generator=gen, engine=engine,
                           dataset_fn=self._datasets,
                           obs=self.obs.tagged(cell=cell.index),
                           device=self.device)

    # ------------------------------------------------------------------
    # Sweep checkpointing: per-cell runner snapshots
    # plus a JSON manifest written LAST — the manifest is the commit point,
    # so a kill mid-save is detected on resume (cell cursor mismatch) rather
    # than silently resumed from torn state. Each cell file itself is
    # written atomically (checkpoint/io.py).
    # ------------------------------------------------------------------
    CKPT_SCHEMA = "repro_torch.exp/sweep-ckpt/v1"

    def _save_checkpoint(self, directory: str, runners, completed: int):
        os.makedirs(directory, exist_ok=True)
        for i, r in enumerate(runners):
            r.save_checkpoint(os.path.join(directory, f"cell_{i:04d}.npz"))
        man = {"schema": self.CKPT_SCHEMA, "spec": self.spec.to_payload(),
               "completed_rounds": int(completed), "cells": len(runners)}
        path = os.path.join(directory, "manifest.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(man, f, sort_keys=True)
        os.replace(tmp, path)

    def _try_resume(self, directory: str, runners) -> int:
        """Load a previous checkpoint if one exists; returns the lockstep
        round to resume at (0 = fresh start)."""
        path = os.path.join(directory, "manifest.json")
        if not os.path.exists(path):
            return 0
        with open(path) as f:
            man = json.load(f)
        if man.get("schema") != self.CKPT_SCHEMA:
            raise ValueError(f"sweep checkpoint schema {man.get('schema')!r}"
                             f" != {self.CKPT_SCHEMA!r}")
        if man.get("spec") != self.spec.to_payload():
            raise ValueError("sweep checkpoint belongs to a different "
                             "ExperimentSpec; refusing to resume")
        if man.get("cells") != len(runners):
            raise ValueError(f"sweep checkpoint has {man.get('cells')} cells"
                             f", spec expands to {len(runners)}")
        completed = int(man["completed_rounds"])
        for i, r in enumerate(runners):
            r.load_checkpoint(os.path.join(directory, f"cell_{i:04d}.npz"))
            want = min(completed, r.run.rounds)
            if r.next_round != want:
                raise ValueError(
                    f"cell {i} checkpoint is at round {r.next_round}, "
                    f"manifest says {want} — torn checkpoint (killed "
                    "mid-save); delete the directory and restart")
        return completed

    # ------------------------------------------------------------------
    def run(self, checkpoint_dir: str | None = None,
            checkpoint_every: int = 1,
            stop_after: int | None = None) -> "SweepResult":
        """Execute the grid in round-lockstep. With `checkpoint_dir`, all
        cell state is snapshotted every `checkpoint_every` lockstep rounds
        and a later `run()` with the same directory resumes bitwise from
        the last completed round. `stop_after` limits how many lockstep
        rounds THIS call executes (tests use it to simulate a kill)."""
        cells = self.spec.expand()
        runners = [self._make_runner(c) for c in cells]
        n = len(cells)
        max_rounds = max(c.run.rounds for c in cells)
        start_round = 0
        if checkpoint_dir is not None:
            start_round = self._try_resume(checkpoint_dir, runners)
        logs: List[List] = [list(r.logs) for r in runners]
        dispatches = 0
        batched_fleets = 0
        largest_batch = 0
        executed = 0

        for t in range(start_round, max_rounds):
            if stop_after is not None and executed >= stop_after:
                break
            active = [i for i in range(n) if t < cells[i].run.rounds]
            pending = {i: runners[i].begin_round(t) for i in active}
            plans: Dict[int, Any] = {}

            # group torch-planner cells by the only things the SUBP2-4 BCD
            # reads besides the fleet: the (post-scenario) GenFVConfig,
            # model_bits and the generation service (cells with different
            # measured/assumed t0 price eq. 48 differently and cannot share
            # a dispatch). numpy-planner cells keep the host reference.
            groups: Dict[tuple, List[int]] = {}
            for i in active:
                r = runners[i]
                if r.run.planner == "torch":
                    groups.setdefault((r.cfg, r.model_bits, r.svc),
                                      []).append(i)
                else:
                    plans[i] = r.plan(pending[i])
            for key in sorted(groups, key=lambda k: groups[k][0]):
                cfg, model_bits, svc = key
                idxs = groups[key]
                with self.obs.span("sweep/plan_batched", key=len(idxs),
                                   round=t, fleets=len(idxs)):
                    batch = plan_rounds_batched(
                        cfg, [pending[i].fleet for i in idxs], model_bits,
                        batches=cfg.local_steps,
                        b_prevs=[runners[i].b_prev for i in idxs],
                        svc=svc,
                        alpha_overrides=[pending[i].alpha for i in idxs],
                        device=self.device, obs=self.obs)
                dispatches += 1
                batched_fleets += len(idxs)
                largest_batch = max(largest_batch, len(idxs))
                for i, plan in zip(idxs, batch):
                    plans[i] = plan

            for i in active:
                log = runners[i].finish_round(pending[i], plans[i])
                logs[i].append(log)
                if self.verbose:
                    c = cells[i]
                    log_line(
                        self.obs, f"sweep/cell_{c.index}",
                        f"[{c.strategy}/{c.scenario}/a{c.alpha}/s{c.seed}]"
                        f" round {t:3d} sel={log.selected:2d}"
                        f" drop={log.dropped} t_bar={log.t_bar:5.2f}s"
                        f" loss={log.loss:.3f} acc={log.accuracy:.3f}",
                        force=t == c.run.rounds - 1,
                        cell=c.index, round=t)

            executed += 1
            if checkpoint_dir is not None and \
                    (t + 1) % max(checkpoint_every, 1) == 0:
                with self.obs.span("sweep/checkpoint", round=t):
                    self._save_checkpoint(checkpoint_dir, runners, t + 1)

        meta = {
            "planner_dispatches": dispatches,
            "planner_batched_fleets": batched_fleets,
            "planner_largest_batch": largest_batch,
            "dataset_builds": self._datasets.builds,
            "dataset_cache_hits": self._datasets.hits,
            "engines": len(self._engines),
            "local_steps": [int(r.cfg.local_steps) for r in runners],
        }
        if self.obs.enabled:
            # the Sweep's sharing ledger: batched-planner amortization and
            # cache efficacy
            self.obs.gauge("sweep/planner_dispatches", dispatches)
            self.obs.gauge("sweep/planner_batched_fleets", batched_fleets)
            self.obs.gauge("sweep/planner_largest_batch", largest_batch)
            self.obs.gauge("sweep/dataset_builds", self._datasets.builds)
            self.obs.gauge("sweep/dataset_cache_hits", self._datasets.hits)
            self.obs.gauge("sweep/engines", len(self._engines))
            self.obs.gauge("sweep/cells", n)
        return SweepResult.build(self.spec, cells, logs, meta)


# ---------------------------------------------------------------------------
# Struct-of-arrays result.
# ---------------------------------------------------------------------------
@dataclass
class SweepResult:
    spec: ExperimentSpec
    cells: List[Dict[str, Any]]            # coords + run fields per cell
    rounds: np.ndarray                     # [n] realized rounds
    metrics: Dict[str, np.ndarray]         # key -> [n, max_rounds] float64
    meta: Dict[str, Any] = field(default_factory=dict)

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, spec: ExperimentSpec, cells: Sequence[Cell],
              logs: Sequence[Sequence], meta: Dict[str, Any]
              ) -> "SweepResult":
        n = len(cells)
        rounds = np.array([len(lg) for lg in logs], np.int64)
        width = int(rounds.max()) if n else 0
        metrics = {k: np.full((n, width), np.nan) for k in METRIC_KEYS}
        for i, lg in enumerate(logs):
            for t, log in enumerate(lg):
                for k in METRIC_KEYS:
                    metrics[k][i, t] = float(getattr(log, k))
        local_steps = meta.pop("local_steps", [None] * n)
        cell_rows = []
        for i, c in enumerate(cells):
            row = c.coords()
            row["run"] = run_payload(c.run)
            row["local_steps"] = local_steps[i]
            cell_rows.append(row)
        return cls(spec, cell_rows, rounds, metrics, dict(meta))

    # -- selection ---------------------------------------------------------
    def _match(self, **coords) -> List[int]:
        def ok(row):
            for k, v in coords.items():
                have = row[k] if k in row else row["run"].get(k)
                if have != v:
                    return False
            return True
        return [i for i, row in enumerate(self.cells) if ok(row)]

    def select(self, **coords) -> "SweepResult":
        """Subset result for the cells matching the given coordinates
        (axis names or RunConfig fields), e.g. select(scenario="rush_hour")."""
        idx = self._match(**coords)
        if not idx:
            raise KeyError(f"no cells match {coords}")
        meta = dict(self.meta)
        meta["selected_from"] = len(self.cells)
        # trim the metric columns to the subset's realized width so the
        # payload's max_rounds stays consistent with the array shape
        width = int(self.rounds[idx].max())
        return SweepResult(
            self.spec,
            [self.cells[i] for i in idx],
            self.rounds[idx],
            {k: v[idx][:, :width] for k, v in self.metrics.items()},
            meta)

    def curve(self, key: str, **coords) -> np.ndarray:
        """The [rounds] metric curve of exactly one cell."""
        idx = self._match(**coords) if coords else list(range(len(self.cells)))
        if len(idx) != 1:
            raise KeyError(f"curve({key!r}, {coords}) matches {len(idx)} "
                           f"cells; need exactly 1")
        i = idx[0]
        return self.metrics[key][i, :int(self.rounds[i])]

    def final(self, key: str) -> np.ndarray:
        """[n_cells] last-realized-round value of a metric."""
        out = np.empty(len(self.cells))
        for i, r in enumerate(self.rounds):
            out[i] = self.metrics[key][i, int(r) - 1] if r else np.nan
        return out

    # -- serialization -----------------------------------------------------
    def to_payload(self) -> Dict[str, Any]:
        def col(a):
            return [None if not np.isfinite(x) else float(x)
                    for x in np.asarray(a, np.float64).ravel()]
        # max_rounds is the metric column width by contract (from_payload
        # reshapes on it) — read it off the arrays, not off self.rounds
        width = (next(iter(self.metrics.values())).shape[1]
                 if self.cells else 0)
        return {
            "schema": SWEEP_SCHEMA,
            "spec": self.spec.to_payload(),
            "cells": self.cells,
            "rounds": [int(r) for r in self.rounds],
            "n_cells": len(self.cells),
            "max_rounds": width,
            "metrics": {k: col(v) for k, v in self.metrics.items()},
            "meta": self.meta,
        }

    def to_json(self) -> str:
        """Canonical bytes: equal results serialize identically."""
        return json.dumps(self.to_payload(), sort_keys=True,
                          separators=(",", ":"), allow_nan=False)

    def save(self, directory: str | None = None) -> str:
        """Write the versioned sweep artifact; returns the path."""
        payload = self.to_payload()
        payload.pop("schema")              # save_artifact injects the tag
        return save_artifact(self.spec.name, "sweep", payload,
                             directory=directory)

    @classmethod
    def from_payload(cls, doc: Dict[str, Any]) -> "SweepResult":
        spec = ExperimentSpec.from_payload(doc["spec"])
        rounds = np.array(doc["rounds"], np.int64)
        n, width = doc["n_cells"], doc["max_rounds"]
        metrics = {}
        for k, flat in doc["metrics"].items():
            a = np.array([np.nan if v is None else v for v in flat],
                         np.float64)
            metrics[k] = a.reshape(n, width)
        return cls(spec, doc["cells"], rounds, metrics, doc.get("meta", {}))

    @classmethod
    def load(cls, path: str) -> "SweepResult":
        return cls.from_payload(load_artifact(path, kind="sweep"))
