"""GenFV round orchestration (paper Fig. 2 workflow + Algorithm 3) with the
baseline schemes of Sec. VI-B: FedAvg, No-EMD, OCEAN-a, MADCA-FL, FL-only,
AIGC-only and FedProx. The counterpart of the JAX package's
`fl/rounds.py`, synchronous and fault-free.

Each round:
  1. label sharing: vehicles report label histograms -> EMD_n
  2. SUBP1 selection (strategy-dependent)
  3. SUBP2-4 resource allocation (two-scale BCD) -> RoundPlan + delay ledger
  4. selected vehicles run h local SGD steps (vmapped, fl/fleet.py)
  5. RSU generates b images (SUBP4 schedule) and trains the augmented model
  6. EMD-weighted aggregation (eq. 4)

Steps 1-3 and the world run in host numpy (the planner's BCD in float64 on
the device); steps 4-6 and evaluation run in torch on `device`. With the
same `RunConfig` the runner draws its numpy RNG stream in the JAX
package's order, so fleets, selections, batches and generated images agree
with the reference bit for bit; the CNN's initial weights come from a
torch generator and cannot (`convert.from_jax_cnn_params` carries the
reference's over). Not ported yet, each raising `NotImplementedError`:
fault injection, the sequential path (`vectorized=False`), the DDPM
generator, checkpoints; streaming has no entry point here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import GenFVConfig, StreamConfig
from repro_torch.configs.genfv_cifar import CNNConfig, cnn_config
from repro_torch.core import mobility, plan_round
from repro_torch.core.generation import label_schedule
from repro_torch.core.planner import RoundPlan, bucket_size
from repro_torch.core.selection import (dropout_mask, select, select_madca,
                                        select_no_emd, select_ocean,
                                        select_random)
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import DATASET_CLASSES, make_image_dataset
from repro_torch.fl.client import images_to_device, labels_to_device
from repro_torch.fl.fleet import FleetEngine
from repro_torch.fl.generator import OracleGenerator
from repro_torch.fl.server import GenFVServer
from repro_torch.models.api import resolve_device
from repro_torch.models.cnn import cnn_forward, init_cnn
from repro_torch.obs import NULL_OBS, log_line
from repro_torch.sim import LEGACY, VehicularWorld, get_scenario, \
    scenario_names
from repro_torch.tree import tree_leaves

STRATEGIES = ("genfv", "fedavg", "no_emd", "madca", "ocean",
              "fl_only", "aigc_only", "fedprox")

#: SUBP2-4 backends of core/two_scale.py::plan_round: "torch" is the
#: counterpart of the JAX package's "jax".
PLANNERS = ("torch", "numpy")

#: AIGC services of the JAX package; only "oracle" is ported.
GENERATORS = ("oracle", "ddpm")

# moderate client lr: high-lr few-class local models drift into incompatible
# basins and weight-average destructively
CLIENT_LR = 5e-2

#: test images per forward pass of the evaluation
EVAL_CHUNK = 2048

_FAULTS = ("fault injection is not ported yet: ROADMAP.md Queue 1 item 4 "
           "(fl/faults.py, the guarded eq. 4 and the stale buffer)")
_SEQUENTIAL = ("the sequential per-vehicle path (vectorized=False) is not "
               "ported yet: ROADMAP.md Queue 1 item 6")
_CHECKPOINTS = ("runner checkpoints are not ported yet: ROADMAP.md Queue 1 "
                "item 7 (checkpoints and the enabled tracer)")
_DDPM = ("the DDPM generator is not ported yet: ROADMAP.md Queue 1 item 8 "
         "(the AIGC dataplane)")


def validate_run_fields(strategy: str, scenario: str, planner: str,
                        dataset: str) -> None:
    """Registry validation of `RunConfig`: unknown names raise at
    construction with the valid names spelled out."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; valid: "
                         f"{', '.join(STRATEGIES)}")
    if scenario != LEGACY and scenario not in scenario_names():
        raise ValueError(
            f"unknown scenario {scenario!r}; registered: "
            f"{', '.join(scenario_names())} (or {LEGACY!r} for the "
            f"memoryless sampler)")
    if planner not in PLANNERS:
        raise ValueError(f"unknown planner {planner!r}; valid: "
                         f"{', '.join(PLANNERS)}")
    if dataset not in DATASET_CLASSES:
        raise ValueError(f"unknown dataset {dataset!r}; valid: "
                         f"{', '.join(DATASET_CLASSES)}")


def eval_stream_seed(seed: int) -> int:
    """RNG seed of the held-out eval set for run seed `seed`: a spawned
    child `SeedSequence`, so no run seed's eval stream is another seed's
    train stream."""
    child = np.random.SeedSequence(seed).spawn(1)[0]
    return int(child.generate_state(1, np.uint64)[0])


@dataclass(frozen=True)
class RunConfig:
    """One experiment cell, field for field the JAX package's `RunConfig`;
    the planner names differ ("torch" here, "jax" there)."""
    dataset: str = "cifar10"
    alpha: float = 0.1
    rounds: int = 20
    strategy: str = "genfv"
    train_size: int = 4000
    test_size: int = 512
    width_mult: float = 0.25
    seed: int = 0
    model_bits: float | None = None      # default: 32 bits/param of the CNN
    vectorized: bool = True              # fused fleet engine (the only
                                         # path ported)
    # Fleet source: a sim scenario name (persistent world, default) or
    # "legacy" for the memoryless per-round i.i.d. sampler.
    scenario: str = "highway_free_flow"
    # SUBP2-4 backend: "torch" (device float64 BCD, default) or "numpy"
    # (host reference solver)
    planner: str = "torch"
    # Named fault schedule of the JAX package, or None (fault-free).
    faults: str | None = None
    # Streaming round policy; ignored by the synchronous `train()` loop.
    stream: StreamConfig | None = None
    # AIGC service (GENERATORS): "oracle" or "ddpm".
    generator: str = "oracle"
    # DDIM-style stride of the DDPM's noise schedule; ignored by the oracle.
    sampler_steps: int = 50
    # Observability handle: an object with the `NullObs` interface, or None
    # for the null path. Excluded from equality and hashing.
    obs: object | None = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        validate_run_fields(self.strategy, self.scenario, self.planner,
                            self.dataset)
        if self.generator not in GENERATORS:
            raise ValueError(f"unknown generator {self.generator!r}; "
                             f"valid: {', '.join(GENERATORS)}")
        if self.sampler_steps < 1:
            raise ValueError(
                f"sampler_steps must be >= 1, got {self.sampler_steps}")
        if isinstance(self.stream, dict):
            object.__setattr__(self, "stream",
                               StreamConfig.from_payload(self.stream))


@dataclass
class RoundLog:
    round: int
    selected: int
    t_bar: float
    b_gen: int
    kappa2: float
    emd_bar: float
    loss: float
    accuracy: float
    dropped: int = 0     # selected vehicles that left coverage mid-round
    # -- fault-tolerance ledger (all zero on fault-free runs) --------------
    late: int = 0
    rejected: int = 0
    stale_merged: int = 0
    stale_dropped: int = 0
    t_round: float = 0.0   # realized wall-clock (= t_bar without faults)
    # -- planner diagnostics ------------------------------------------------
    bcd_iters: int = 0         # SUBP2-4 BCD outer iterations this round
    planner_converged: int = 1  # 0 iff the BCD hit its iteration cap


@dataclass
class RunResult:
    logs: List[RoundLog] = field(default_factory=list)

    def curve(self, key: str) -> np.ndarray:
        return np.array([getattr(l, key) for l in self.logs])


@dataclass
class PendingRound:
    """A round between `begin_round` (fleet + SUBP1 done) and
    `finish_round` (waiting on its SUBP2-4 `RoundPlan`)."""
    t: int
    fleet: List
    parts: np.ndarray
    alpha: np.ndarray


class GenFVRunner:
    """The synchronous GenFV round loop. The model, the fleet step, the
    aggregation, the evaluation and the torch planner run on `device`
    ("cuda" unless the caller asks for another; raises without CUDA)."""

    def __init__(self, run: RunConfig, obs=None, device="cuda"):
        self.device = resolve_device(device)
        if run.faults is not None:
            raise NotImplementedError(_FAULTS)
        if not run.vectorized:
            raise NotImplementedError(_SEQUENTIAL)
        if run.generator == "ddpm":
            raise NotImplementedError(_DDPM)
        self.run = run
        # spans only: the port has no enabled tracer yet
        self.obs = obs if obs is not None else (
            run.obs if run.obs is not None else NULL_OBS)
        self.cfg = GenFVConfig(dirichlet_alpha=run.alpha)
        self.scenario = None if run.scenario == LEGACY \
            else get_scenario(run.scenario)
        if self.scenario is not None:
            self.cfg = self.scenario.apply(self.cfg)
        self.rng = np.random.default_rng(run.seed)
        self.cnn_cfg: CNNConfig = cnn_config(run.dataset, run.width_mult)
        classes = DATASET_CLASSES[run.dataset]

        imgs, labels = make_image_dataset(run.dataset, run.train_size,
                                          seed=run.seed)
        self.test_imgs, self.test_labels = make_image_dataset(
            run.dataset, run.test_size, seed=eval_stream_seed(run.seed))
        parts = dirichlet_partition(labels, self.cfg.num_vehicles, run.alpha,
                                    self.rng)
        self.client_data = [(imgs[ix], labels[ix]) for ix in parts]
        self.hists = [np.bincount(labels[ix], minlength=classes) /
                      max(len(ix), 1) for ix in parts]
        self.sizes = [len(ix) for ix in parts]
        self.world = None if self.scenario is None else VehicularWorld(
            self.cfg, self.scenario, n_partitions=len(self.client_data),
            rng=self.rng)

        gen = torch.Generator(device=self.device).manual_seed(run.seed)
        params = init_cnn(gen, self.cnn_cfg, self.device)
        n_params = sum(x.numel() for x in tree_leaves(params))
        # explicit None check: model_bits=0.0 is a legal override (free comms)
        self.model_bits = (run.model_bits if run.model_bits is not None
                           else n_params * 32.0)
        self.server = GenFVServer(self.cnn_cfg, params,
                                  OracleGenerator(run.dataset), self.rng)
        self.engine = FleetEngine(self.cnn_cfg, self.cfg.local_steps,
                                  self.cfg.batch_size, lr=CLIENT_LR)
        self.classes = classes
        self.b_prev = 0
        self.logs: List[RoundLog] = []
        self.next_round = 0
        self._test_x = images_to_device(self.test_imgs, self.device)
        self._test_y = labels_to_device(self.test_labels, self.device)

    # ------------------------------------------------------------------
    def _alpha(self, fleet, round_idx: int) -> np.ndarray:
        s = self.run.strategy
        batches = self.cfg.local_steps
        if s in ("genfv", "aigc_only", "fl_only"):
            return select(self.cfg, fleet, self.model_bits, batches).alpha
        if s in ("fedprox", "fedavg"):
            return select_random(self.rng, fleet, k=max(
                1, int(0.3 * len(fleet))))
        if s == "no_emd":
            return select_no_emd(self.cfg, fleet, self.model_bits, batches)
        if s == "madca":
            return select_madca(self.cfg, fleet, self.model_bits, batches)
        if s == "ocean":
            return select_ocean(self.cfg, fleet, self.model_bits, batches,
                                round_idx, self.run.rounds)
        raise ValueError(s)

    @torch.no_grad()
    def evaluate(self) -> float:
        """Accuracy of the global model on the held-out set (argmax of the
        logits against the labels), as the JAX package's float32 mean."""
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(0, len(self.test_labels), EVAL_CHUNK):
            logits = cnn_forward(self.server.params, self.cnn_cfg,
                                 self._test_x[i:i + EVAL_CHUNK])
            correct += (logits.argmax(-1)
                        == self._test_y[i:i + EVAL_CHUNK]).sum()
        return float(np.float32(int(correct))
                     / np.float32(len(self.test_labels)))

    # ------------------------------------------------------------------
    # Round lifecycle: `run_round` = begin -> plan -> finish. `begin_round`
    # consumes self.rng in the JAX package's order; planning draws nothing.
    # ------------------------------------------------------------------
    def begin_round(self, t: int) -> PendingRound:
        """Phase 1: materialize the round's fleet and run SUBP1 selection."""
        cfg = self.cfg
        with self.obs.span("round/fleet", round=t):
            if self.world is None:
                order = self.rng.permutation(len(self.client_data))
                hists = [self.hists[i] for i in order]
                sizes = [self.sizes[i] for i in order]
                fleet = mobility.sample_fleet(self.rng, cfg, hists, sizes)
                parts = order                   # parts[j]: fleet[j]'s data
            else:
                fleet, parts = self.world.fleet(self.hists, self.sizes)

        with self.obs.span("round/select", round=t, fleet=len(fleet)):
            alpha = self._alpha(fleet, t) if fleet else np.zeros(0, np.int32)
        return PendingRound(t, fleet, parts, alpha)

    def plan(self, pending: PendingRound) -> RoundPlan:
        """Phase 2: SUBP2-4 resource allocation for one pending round."""
        bucket = bucket_size(len(pending.fleet)) if pending.fleet else 0
        key = (self.run.planner, bucket) if self.run.planner == "torch" \
            else None
        # no sync needed: plan_round returns host arrays
        with self.obs.span("round/plan", key=key, round=pending.t,
                           planner=self.run.planner, bucket=bucket):
            plan = plan_round(self.cfg, pending.fleet, self.model_bits,
                              self.cfg.local_steps, b_prev=self.b_prev,
                              alpha_override=pending.alpha,
                              planner=self.run.planner, device=self.device)
        return plan

    def finish_round(self, pending: PendingRound, plan: RoundPlan) -> RoundLog:
        """Phase 3: the round closes at t_bar; in the persistent world a
        selected vehicle whose holding time falls short of it leaves
        coverage before uploading (the legacy sampler keeps everyone)."""
        t_round = plan.t_bar
        survive = None
        if self.world is not None and plan.selected:
            t_run = min(t_round, self.cfg.t_max)
            survive = dropout_mask(self.cfg, pending.fleet, plan.selected,
                                   t_run)
        return self._execute_round(pending, plan, t_round=t_round,
                                   survive=survive)

    def _execute_round(self, pending: PendingRound, plan: RoundPlan, *,
                       t_round: float, survive) -> RoundLog:
        """Execute one planned round: generation and omega_a, the fleet step
        with eq. 4, world step, eval. The fault-free, vectorized branch of
        the JAX package's `_execute_round`."""
        run, cfg, t = self.run, self.cfg, pending.t
        fleet, parts = pending.fleet, pending.parts
        self.b_prev = plan.b_gen

        dropped = 0
        use_aigc = run.strategy in ("genfv", "aigc_only")
        use_fl = run.strategy != "aigc_only"
        prox_mu = 0.1 if run.strategy == "fedprox" else 0.0

        # AIGC generation + augmented training run first: omega_a depends
        # only on the round-start global model.
        aug = None
        loss = 0.0
        if use_aigc:
            with self.obs.span("round/generate", round=t,
                               b_gen=plan.b_gen) as sp:
                counts = label_schedule(
                    plan.b_gen if use_fl else cfg.gen_batch * 4,
                    self.classes)
                self.server.generate(counts, round_idx=t)
                aug, aug_loss = self.server.train_augmented(
                    cfg.local_steps * cfg.rsu_steps_factor, cfg.batch_size,
                    lr=CLIENT_LR)
                sp.sync = aug
            if not use_fl:
                loss = aug_loss

        n_trained = 0
        memds = []
        if use_fl:
            msizes = []
            bimgs, blabels = [], []
            with self.obs.span("round/local_sgd", round=t,
                               selected=len(plan.selected), vectorized=1):
                for pos, j in enumerate(plan.selected):
                    if survive is not None and not survive[pos]:
                        dropped += 1
                        continue
                    v = fleet[j]
                    di, dl = self.client_data[parts[j]]
                    if len(dl) < 2:
                        continue
                    bi, bl = self.engine.sample_batches(self.rng, di, dl)
                    bimgs.append(bi)
                    blabels.append(bl)
                    msizes.append(v.data_size)
                    memds.append(v.emd)
            n_trained = len(msizes)

            with self.obs.span("round/aggregate",
                               key=(bucket_size(len(bimgs)), False)
                               if bimgs else None,
                               round=t, guard=0, stale=0) as sp:
                if bimgs:
                    _, (k1, k2), losses = self.server.fleet_round(
                        self.engine, bimgs, blabels, msizes, memds,
                        aug if use_aigc else None, prox_mu)
                    loss = float(losses.mean())
                else:
                    # nobody trained: eq. 4 over no models keeps the
                    # globals, or takes omega_a when there is one
                    if use_aigc:
                        self.server.params = aug
                    k1, k2 = 1.0, 0.0
                sp.sync = self.server.params

        if run.strategy == "aigc_only":
            self.server.params = aug
            k2 = 1.0
            emd_bar = 0.0
        else:
            emd_bar = float(np.mean(memds)) if memds else 0.0

        # advance the world by the round's wall-clock: the straggler window
        # (or the RSU's generation window if longer, AIGC strategies only),
        # floored so an empty round still consumes its slot, capped at t_max
        if self.world is not None:
            with self.obs.span("round/world_step", round=t):
                t_rsu = plan.t_rsu if use_aigc else 0.0
                dt = max(t_round, t_rsu, 0.0) if plan.selected \
                    else max(cfg.t_max, 0.0)
                self.world.step(self.rng, float(
                    np.clip(dt, 0.25 * cfg.t_max, cfg.t_max)))

        # float() reads the device value: the eval span fences itself
        with self.obs.span("round/eval", round=t):
            acc = self.evaluate()
        log = RoundLog(t, n_trained, plan.t_bar, plan.b_gen, k2,
                       emd_bar, float(loss), acc, dropped,
                       t_round=float(t_round), bcd_iters=plan.bcd_iters,
                       planner_converged=int(plan.converged))
        self.logs.append(log)
        self.next_round = t + 1
        return log

    def run_round(self, t: int) -> RoundLog:
        pending = self.begin_round(t)
        return self.finish_round(pending, self.plan(pending))

    # ------------------------------------------------------------------
    def train(self, verbose: bool = False, checkpoint_path: str | None = None,
              checkpoint_every: int = 1) -> RunResult:
        """Run the remaining rounds; returns every completed round's log."""
        if checkpoint_path is not None:
            raise NotImplementedError(_CHECKPOINTS)
        for t in range(self.next_round, self.run.rounds):
            log = self.run_round(t)
            if verbose:
                log_line(
                    self.obs, "train/round",
                    f"[{self.run.strategy}] round {t:3d} "
                    f"sel={log.selected:2d} drop={log.dropped} "
                    f"t_bar={log.t_bar:5.2f}s b={log.b_gen:4d} "
                    f"k2={log.kappa2:.3f} loss={log.loss:.3f} "
                    f"acc={log.accuracy:.3f}",
                    force=t == self.run.rounds - 1,
                    round=t, accuracy=log.accuracy)
        return RunResult(list(self.logs))

    def save_checkpoint(self, path: str) -> str:
        raise NotImplementedError(_CHECKPOINTS)

    def load_checkpoint(self, path: str) -> int:
        raise NotImplementedError(_CHECKPOINTS)
