"""GenFV round orchestration (paper Fig. 2 workflow + Algorithm 3) with the
baseline schemes of Sec. VI-B: FedAvg, No-EMD, OCEAN-a, MADCA-FL, FL-only,
AIGC-only and FedProx. The counterpart of the JAX package's
`fl/rounds.py`: the synchronous loop with fault injection and recovery,
the vectorized and the sequential per-vehicle paths, runner checkpoints
and an attachable tracer.

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
with the reference bit for bit; fault draws are round-keyed
(fl/faults.py), so faulted runs agree too. The CNN's initial weights come
from a torch generator and cannot (`convert.from_jax_cnn_params` carries
the reference's over). `generator="ddpm"` samples each round's SUBP4
schedule with the pretrained DDPM (repro_torch.gen) and prices eq. 48 with
its measured per-image time. The event-driven streaming engine
(fl/stream.py) drives the same `_execute_round` body, and experiment
sweeps (repro_torch.exp) inject a shared fleet engine and dataset cache.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Callable, List

import numpy as np
import torch

from repro_torch.checkpoint import read_manifest, restore_tree, save_tree
from repro_torch.configs.base import GenFVConfig, StreamConfig
from repro_torch.configs.genfv_cifar import CNNConfig, cnn_config
from repro_torch.core import mobility, plan_round
from repro_torch.core.emd import add_weighted, tree_finite
from repro_torch.core.generation import label_schedule
from repro_torch.core.planner import RoundPlan, bucket_size
from repro_torch.core.selection import (dropout_mask, select, select_madca,
                                        select_no_emd, select_ocean,
                                        select_random)
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import DATASET_CLASSES, make_image_dataset
from repro_torch.fl.client import (client_update, images_to_device,
                                   labels_to_device, local_sgd_steps)
from repro_torch.fl.faults import (FaultInjector, FaultSpec, StaleBuffer,
                                   StaleEntry, fault_names, get_fault,
                                   realized_times)
from repro_torch.fl.fleet import FleetEngine
from repro_torch.fl.generator import OracleGenerator
from repro_torch.fl.server import GenFVServer
from repro_torch.models.api import resolve_device
from repro_torch.models.cnn import cnn_forward, init_cnn
from repro_torch.obs import NULL_OBS, log_line
from repro_torch.sim import LEGACY, VehicularWorld, WorldState, \
    get_scenario, scenario_names
from repro_torch.tree import tree_leaves, tree_map

STRATEGIES = ("genfv", "fedavg", "no_emd", "madca", "ocean",
              "fl_only", "aigc_only", "fedprox")

#: SUBP2-4 backends of core/two_scale.py::plan_round: "torch" is the
#: counterpart of the JAX package's "jax".
PLANNERS = ("torch", "numpy")

#: AIGC services: the procedural oracle and the pretrained DDPM.
GENERATORS = ("oracle", "ddpm")

# moderate client lr: high-lr few-class local models drift into incompatible
# basins and weight-average destructively
CLIENT_LR = 5e-2

#: test images per forward pass of the evaluation
EVAL_CHUNK = 2048


def validate_run_fields(strategy: str, scenario: str, planner: str,
                        dataset: str, faults: str | None = None) -> None:
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
        # names quoted, so the JAX package's "jax" is refused naming "torch"
        raise ValueError(f"unknown planner {planner!r}; valid: "
                         f"{', '.join(map(repr, PLANNERS))}")
    if dataset not in DATASET_CLASSES:
        raise ValueError(f"unknown dataset {dataset!r}; valid: "
                         f"{', '.join(DATASET_CLASSES)}")
    if faults is not None and faults not in fault_names():
        raise ValueError(f"unknown fault schedule {faults!r}; registered: "
                         f"{', '.join(fault_names())} (or None for a "
                         "fault-free run)")


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
    vectorized: bool = True              # fleet engine vs sequential
                                         # per-vehicle path
    # Fleet source: a sim scenario name (persistent world, default) or
    # "legacy" for the memoryless per-round i.i.d. sampler.
    scenario: str = "highway_free_flow"
    # SUBP2-4 backend: "torch" (device float64 BCD, default) or "numpy"
    # (host reference solver)
    planner: str = "torch"
    # Named fault schedule of fl/faults.py's registry, or None (fault-free).
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
                            self.dataset, self.faults)
        if self.generator not in GENERATORS:
            raise ValueError(f"unknown generator {self.generator!r}; "
                             f"valid: {', '.join(GENERATORS)}")
        if self.sampler_steps < 1:
            raise ValueError(
                f"sampler_steps must be >= 1, got {self.sampler_steps}")
        if isinstance(self.stream, dict):
            object.__setattr__(self, "stream",
                               StreamConfig.from_payload(self.stream))


def run_payload(run: "RunConfig") -> dict:
    """JSON-ready dict of the fields that identify the experiment: every
    RunConfig field except the `obs` handle. Checkpoint fingerprints go
    through here, so an attached tracer never invalidates one."""
    return {f.name: (getattr(run, f.name).to_payload()
                     if f.name == "stream" and run.stream is not None
                     else getattr(run, f.name))
            for f in dataclasses.fields(run) if f.name != "obs"}


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
    ("cuda" unless the caller asks for another; raises without CUDA).

    `fl_cfg` replaces the default `GenFVConfig` (the scenario's overrides
    still apply); `generator` replaces the AIGC service `run.generator`
    names and `svc` the service eq. 48 is priced with; `faults`, a
    `FaultSpec`, overrides `run.faults`'s registered schedule; `obs`
    overrides `run.obs`. `engine` is a shared `FleetEngine` (it must match
    this run's model shape) and `dataset_fn` replaces
    `make_image_dataset` (a sweep's exact cache of the same builds)."""
    #: manifest schema of `save_checkpoint` (the layout of the JAX
    #: package's runner-ckpt/v4, with the port's parameter tree)
    CKPT_SCHEMA = "repro_torch.fl/runner-ckpt/v4"

    def __init__(self, run: RunConfig, fl_cfg: GenFVConfig | None = None,
                 generator=None, engine: FleetEngine | None = None,
                 dataset_fn: Callable | None = None,
                 faults: FaultSpec | None = None, obs=None, svc=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.run = run
        self.obs = obs if obs is not None else (
            run.obs if run.obs is not None else NULL_OBS)
        self.cfg = fl_cfg or GenFVConfig(dirichlet_alpha=run.alpha)
        self.scenario = None if run.scenario == LEGACY \
            else get_scenario(run.scenario)
        if self.scenario is not None:
            self.cfg = self.scenario.apply(self.cfg)
        self.rng = np.random.default_rng(run.seed)
        self.cnn_cfg: CNNConfig = cnn_config(run.dataset, run.width_mult)
        classes = DATASET_CLASSES[run.dataset]

        dataset_fn = dataset_fn or make_image_dataset
        imgs, labels = dataset_fn(run.dataset, run.train_size, seed=run.seed)
        self.test_imgs, self.test_labels = dataset_fn(
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
        # The oracle keeps svc=None, so plan_round prices eq. 48 with the
        # assumed DiffusionService as the JAX package does; the ddpm path
        # prices it with the measured per-image time of the sampler on this
        # device. Lazy imports: repro_torch.gen reaches fl.client, which
        # imports this package.
        self.svc = svc
        if generator is None:
            if run.generator == "ddpm":
                from repro_torch.gen.calib import calibrated_service
                from repro_torch.gen.service import make_ddpm_generator
                generator = make_ddpm_generator(
                    run.dataset, classes, run.seed, run.sampler_steps,
                    obs=self.obs, device=self.device)
                if self.svc is None:
                    self.svc = calibrated_service(
                        generator.params, generator.ddpm, run.sampler_steps)
            else:
                generator = OracleGenerator(run.dataset)
        self.server = GenFVServer(self.cnn_cfg, params, generator, self.rng)
        if engine is not None:
            if (engine.cfg != self.cnn_cfg or engine.h != self.cfg.local_steps
                    or engine.batch_size != self.cfg.batch_size
                    or engine.lr != CLIENT_LR):
                raise ValueError(
                    "injected FleetEngine does not match this run's model "
                    f"shape: engine=({engine.cfg.name}, h={engine.h}, "
                    f"B={engine.batch_size}, lr={engine.lr}) vs run="
                    f"({self.cnn_cfg.name}, h={self.cfg.local_steps}, "
                    f"B={self.cfg.batch_size}, lr={CLIENT_LR})")
            self.engine = engine
        else:
            self.engine = FleetEngine(self.cnn_cfg, self.cfg.local_steps,
                                      self.cfg.batch_size, lr=CLIENT_LR)
        self.classes = classes
        self.b_prev = 0
        # fault tolerance (dormant without a spec)
        spec = faults if faults is not None else (
            get_fault(run.faults) if run.faults is not None else None)
        self.faults = FaultInjector(spec) if spec is not None else None
        self.stale = StaleBuffer()
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
                              svc=self.svc, alpha_override=pending.alpha,
                              planner=self.run.planner, device=self.device)
        return plan

    def finish_round(self, pending: PendingRound, plan: RoundPlan) -> RoundLog:
        """Phase 3: realize the round's faults, enforce the deadline
        t_bar * (1 + slack), then execute the round.

        With a `FaultSpec` attached, late-but-finite updates are buffered
        for a staleness-discounted merge in a later round and poisoned ones
        are rejected by the finiteness guard of eq. 4. Without one every
        branch reduces to the fault-free round: the round closes at t_bar,
        and in the persistent world a selected vehicle whose holding time
        falls short of it leaves coverage before uploading (the legacy
        sampler keeps everyone)."""
        cfg = self.cfg
        t = pending.t
        fleet = pending.fleet

        spec = self.faults.spec if self.faults is not None else None
        rf = None
        late_mask = None
        t_round = plan.t_bar
        if spec is not None and plan.selected:
            rf = self.faults.draw(t, len(plan.selected))
            t_real = realized_times(cfg, fleet, plan, self.model_bits, rf,
                                    spec.outage_fade_db)
            deadline = plan.t_bar * (1.0 + spec.deadline_slack)
            late_mask = (t_real > deadline) & ~rf.departed
            # the RSU holds the round open until the last on-time upload,
            # or until the deadline once anyone misses it or departs
            if late_mask.any() or rf.departed.any():
                t_round = float(deadline)
            else:
                t_round = float(max(plan.t_bar, float(t_real.max())))

        survive = None
        if self.world is not None and plan.selected:
            t_run = min(t_round, cfg.t_max)
            survive = dropout_mask(cfg, fleet, plan.selected, t_run)

        # late updates buffered in EARLIER rounds merge now, weighted by
        # staleness-discounted sizes rho_eff ~ |D_n| * gamma^age
        stale_models, stale_weights, stale_emds = [], [], []
        stale_dropped = 0
        if spec is not None and self.run.strategy != "aigc_only":
            entries, ages, stale_dropped = self.stale.pop_mergeable(
                t, spec.max_staleness)
            stale_models = [e.params for e in entries]
            stale_weights = [e.size * spec.staleness_discount ** a
                             for e, a in zip(entries, ages)]
            stale_emds = [e.emd for e in entries]

        return self._execute_round(
            pending, plan, rf=rf, late_mask=late_mask, t_round=t_round,
            survive=survive, stale_models=stale_models,
            stale_weights=stale_weights, stale_emds=stale_emds,
            stale_dropped=stale_dropped, guard_host=spec is not None)

    def _execute_round(self, pending: PendingRound, plan: RoundPlan, *,
                       rf, late_mask, t_round: float, survive,
                       stale_models: List, stale_weights: List[float],
                       stale_emds: List[float], stale_dropped: int = 0,
                       late_sink: Callable | None = None, skip_mask=None,
                       guard_host: bool = False,
                       dt_floor: float = 0.0) -> RoundLog:
        """Execute one planned round: generation and omega_a, local
        training, eq. 4 with the stale merge, world step, evaluation. The
        synchronous loop (`finish_round`) and the streaming engine
        (fl/stream.py) both drive this body.

        `late_mask` marks selected positions that missed the deadline: they
        train outside the fleet step and go to `late_sink(entry, pos)`
        (default: the stale buffer; the streaming engine's in-flight queue).
        `skip_mask` marks positions whose upload can never arrive (retry
        budget exhausted): dropped without drawing from the RNG.
        `stale_weights` are the already-discounted size weights of
        `stale_models`. `guard_host` turns on the sequential path's
        host-side finiteness checks. `dt_floor` floors the world step (the
        streaming cadence)."""
        run, cfg, t = self.run, self.cfg, pending.t
        fleet, parts = pending.fleet, pending.parts
        self.b_prev = plan.b_gen
        if late_sink is None:
            late_sink = lambda entry, pos: self.stale.push(entry)  # noqa: E731

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
        late = rejected = 0
        stale_merged = len(stale_models)
        forced_out: List[int] = []        # vids force-departed this round
        memds = []
        if use_fl:
            msizes = []
            models = []                # sequential path
            fsizes = []                # sizes of the finite (kept) models
            bimgs, blabels = [], []    # vectorized path
            n_poison = 0               # poisoned batches inside the fleet step
            late_models = []           # trained here, outside the fleet step
            with self.obs.span("round/local_sgd", round=t,
                               selected=len(plan.selected),
                               vectorized=int(run.vectorized)) as sp:
                for pos, j in enumerate(plan.selected):
                    if survive is not None and not survive[pos]:
                        dropped += 1
                        continue
                    if rf is not None and rf.departed[pos]:
                        dropped += 1   # forced exit: the update never arrives
                        forced_out.append(fleet[j].vid)
                        continue
                    if skip_mask is not None and skip_mask[pos]:
                        dropped += 1   # retry budget exhausted (streaming)
                        continue
                    v = fleet[j]
                    di, dl = self.client_data[parts[j]]
                    if len(dl) < 2:
                        continue
                    is_late = late_mask is not None and bool(late_mask[pos])
                    is_poisoned = rf is not None and bool(rf.poisoned[pos])
                    if run.vectorized:
                        # sampled before any diversion: the RNG order of the
                        # JAX package
                        bi, bl = self.engine.sample_batches(self.rng, di, dl)
                        if is_late:
                            # missed the deadline: train on the sampled
                            # batches outside the fleet step and buffer the
                            # update for a later round
                            late += 1
                            if is_poisoned:
                                rejected += 1  # poisoned AND late: dropped
                            else:
                                m, _ = local_sgd_steps(
                                    self.server.params, self.cnn_cfg,
                                    images_to_device(bi, self.device),
                                    labels_to_device(bl, self.device),
                                    cfg.local_steps, CLIENT_LR, prox_mu)
                                late_models.append(m)
                                late_sink(StaleEntry(
                                    m, v.data_size, v.emd, t, v.vid), pos)
                            continue
                        if is_poisoned:
                            # NaN batches corrupt the update inside the
                            # fleet step; the guarded eq. 4 rejects it
                            bi = np.full_like(bi, np.nan)
                            n_poison += 1
                        bimgs.append(bi)
                        blabels.append(bl)
                    else:
                        m, l = client_update(self.server.params, self.cnn_cfg,
                                             di, dl, self.rng, cfg.local_steps,
                                             cfg.batch_size, lr=CLIENT_LR,
                                             prox_mu=prox_mu)
                        if is_poisoned:
                            m = tree_map(
                                lambda x: torch.full_like(x, float("nan")), m)
                        if is_late:
                            late += 1
                            if tree_finite(m):
                                late_sink(StaleEntry(
                                    m, v.data_size, v.emd, t, v.vid), pos)
                            else:
                                rejected += 1
                            continue
                        if guard_host and not tree_finite(m):
                            # host-side guard: the vehicle still counts as a
                            # participant (as in the guarded fleet step) but
                            # its weight goes to the finite survivors
                            rejected += 1
                            msizes.append(v.data_size)
                            memds.append(v.emd)
                            continue
                        models.append(m)
                        fsizes.append(v.data_size)
                        loss += l
                    msizes.append(v.data_size)
                    memds.append(v.emd)
                sp.sync = late_models
            n_trained = len(msizes)

            # the span key is the JAX runner's (padded bucket, poison in
            # the step), so the two runners' span stages line up
            agg_bucket = bucket_size(len(bimgs)) if bimgs else 0
            agg_guard = bool(n_poison)
            agg_key = ((agg_bucket, agg_guard)
                       if run.vectorized and bimgs else None)
            if self.obs.enabled and run.vectorized and bimgs:
                self.obs.gauge("fleet/bucket", agg_bucket)
                self.obs.observe("fleet/pad_waste", agg_bucket - len(bimgs))
            with self.obs.span("round/aggregate", key=agg_key, round=t,
                               guard=int(agg_guard),
                               stale=stale_merged) as sp:
                if run.vectorized and bimgs:
                    # eq. 4 runs guarded iff a poisoned batch is in the step,
                    # as in the JAX package: a vehicle that diverges on its
                    # own reaches the aggregate. Unguarded, the mask is all
                    # true (and the chain the same bits on finite rows).
                    # Stale merges take joint fresh + stale weights
                    rhos = kappa_emds = None
                    if stale_models:
                        all_sizes = np.asarray(
                            list(msizes) + list(stale_weights), np.float64)
                        rho_all = all_sizes / max(all_sizes.sum(), 1.0)
                        rhos = rho_all[:len(msizes)]
                        kappa_emds = memds + stale_emds
                    _, (k1, k2), losses, finite = self.server.fleet_round(
                        self.engine, bimgs, blabels, msizes, memds,
                        aug if use_aigc else None, prox_mu,
                        guard=bool(n_poison), rhos=rhos,
                        kappa_emds=kappa_emds)
                    rejected += int((~finite).sum())
                    loss = float(losses[finite].mean()) \
                        if finite.any() else 0.0
                    if stale_models:
                        w = (k1 * rho_all[len(msizes):]).tolist()
                        self.server.params = add_weighted(
                            self.server.params, stale_models, w)
                else:
                    if guard_host and not models and not stale_models \
                            and msizes:
                        # every upload rejected: the federated mass goes to
                        # the round-start global, as in the guarded step
                        models, fsizes = [self.server.params], [sum(msizes)]
                    # sizes follow the KEPT models; the kappa2 EMD pool
                    # spans every participant
                    _, (k1, k2) = self.server.aggregate(
                        models + stale_models,
                        list(fsizes) + list(stale_weights),
                        memds + stale_emds, aug if use_aigc else None)
                    loss = loss / max(len(models), 1)
                sp.sync = self.server.params

        if run.strategy == "aigc_only":
            self.server.params = aug
            k2 = 1.0
            emd_bar = 0.0
        else:
            emd_bar = float(np.mean(memds)) if memds else 0.0

        # advance the world by the round's realized wall-clock: the
        # straggler window, deadline-extended under faults (or the RSU's
        # generation window if longer, AIGC strategies only), floored so an
        # empty round still consumes its slot, capped at t_max
        if self.world is not None:
            with self.obs.span("round/world_step", round=t):
                if forced_out:
                    # fault-injected departures leave before the step (no
                    # RNG drawn, so a benign spec leaves the stream as is)
                    self.world.remove(forced_out)
                t_rsu = plan.t_rsu if use_aigc else 0.0
                dt = max(t_round, t_rsu, dt_floor) if plan.selected \
                    else max(cfg.t_max, dt_floor)
                self.world.step(self.rng, float(
                    np.clip(dt, 0.25 * cfg.t_max, cfg.t_max)))

        # float() reads the device value: the eval span fences itself
        with self.obs.span("round/eval", round=t):
            acc = self.evaluate()
        log = RoundLog(t, n_trained, plan.t_bar, plan.b_gen, k2,
                       emd_bar, float(loss), acc, dropped, late, rejected,
                       stale_merged, stale_dropped, float(t_round),
                       bcd_iters=plan.bcd_iters,
                       planner_converged=int(plan.converged))
        self._record_round(log)
        self.logs.append(log)
        self.next_round = t + 1
        return log

    def _record_round(self, log: RoundLog) -> None:
        """Feed the round's diagnostics into the tracer's metrics registry
        (host reads only; nothing at all on the null path)."""
        obs = self.obs
        if not obs.enabled:
            return
        run = self.run
        obs.observe("planner/bcd_iters", log.bcd_iters, planner=run.planner)
        obs.count("planner/converged", log.planner_converged,
                  planner=run.planner)
        obs.count("planner/rounds", 1, planner=run.planner)
        obs.observe("round/selected", log.selected)
        obs.observe("round/t_bar", log.t_bar)
        obs.observe("round/t_round", log.t_round)
        obs.observe("round/t_overrun", log.t_round - log.t_bar)
        obs.count("faults/late", log.late)
        obs.count("faults/rejected", log.rejected)
        obs.count("faults/stale_merged", log.stale_merged)
        obs.count("faults/stale_dropped", log.stale_dropped)
        obs.count("faults/dropped", log.dropped)
        if self.world is not None:
            self.world.observe(obs)

    def run_round(self, t: int) -> RoundLog:
        pending = self.begin_round(t)
        return self.finish_round(pending, self.plan(pending))

    # ------------------------------------------------------------------
    def train(self, verbose: bool = False, checkpoint_path: str | None = None,
              checkpoint_every: int = 1) -> RunResult:
        """Run (or resume) the remaining rounds; returns every completed
        round's log. After `load_checkpoint` the loop continues at the first
        incomplete round. With `checkpoint_path`, state is saved atomically
        every `checkpoint_every` completed rounds."""
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
            if checkpoint_path is not None and \
                    (t + 1) % max(checkpoint_every, 1) == 0:
                with self.obs.span("round/checkpoint", round=t):
                    self.save_checkpoint(checkpoint_path)
        return RunResult(list(self.logs))

    # ------------------------------------------------------------------
    # Resumable execution. The runner's mutable state: the global
    # parameters, the one numpy Generator (server and world hold it by
    # identity), b_prev, the completed-round logs, the AIGC pool, the world
    # arrays and the stale buffer. Fault draws are round-keyed and the
    # datasets and partition are a pure function of RunConfig, so nothing
    # else needs persisting: a resumed run replays the remaining rounds
    # bitwise (on the card: under deterministic cuDNN).
    # ------------------------------------------------------------------
    _LOG_INT_FIELDS = ("round", "selected", "b_gen", "dropped", "late",
                       "rejected", "stale_merged", "stale_dropped",
                       "bcd_iters", "planner_converged")

    def _logs_state(self) -> dict:
        return {f.name: np.asarray([getattr(l, f.name) for l in self.logs],
                                   np.int64 if f.name in self._LOG_INT_FIELDS
                                   else np.float64)
                for f in dataclasses.fields(RoundLog)}

    def _checkpoint_state(self) -> dict:
        """The runner's complete mutable state as a checkpointable tree
        (the JAX package's layout; `gen` records the measured service)."""
        rng_state = np.frombuffer(
            json.dumps(self.rng.bit_generator.state).encode(), np.uint8)
        entries = self.stale.entries
        return {
            "rng": rng_state.copy(),
            "b_prev": np.int64(self.b_prev),
            "next_round": np.int64(self.next_round),
            "gen": ({} if self.svc is None else
                    {"t_image": np.float64(self.svc.t_per_image),
                     "steps": np.int64(getattr(self.svc, "steps", 0))}),
            "params": self.server.params,
            "logs": self._logs_state(),
            "pool": ({} if self.server.pool_imgs is None else
                     {"imgs": self.server.pool_imgs,
                      "labels": self.server.pool_labels}),
            "world": ({} if self.world is None else {
                "arrays": dataclasses.asdict(self.world.state),
                "free": np.asarray(self.world._free, np.int64),
                "next_vid": np.int64(self.world._next_vid),
                "stats": {k: np.float64(v) for k, v in
                          dataclasses.asdict(self.world.stats).items()},
            }),
            "stale": ({} if not entries else {
                "params": [e.params for e in entries],
                "size": np.asarray([e.size for e in entries], np.int64),
                "emd": np.asarray([e.emd for e in entries], np.float64),
                "trained_round": np.asarray(
                    [e.trained_round for e in entries], np.int64),
                "vid": np.asarray([e.vid for e in entries], np.int64),
            }),
        }

    def save_checkpoint(self, path: str) -> str:
        """Atomic snapshot of all mutable round state (checkpoint/io.py);
        parameters are copied to the host."""
        meta = {"schema": self.CKPT_SCHEMA, "run": run_payload(self.run)}
        return save_tree(path, self._checkpoint_state(), metadata=meta)

    def _check_manifest(self, meta: dict) -> None:
        if meta.get("schema") != self.CKPT_SCHEMA:
            raise ValueError(f"checkpoint schema {meta.get('schema')!r} != "
                             f"{self.CKPT_SCHEMA!r}")
        if meta.get("run") != run_payload(self.run):
            raise ValueError(
                "checkpoint was written by a different RunConfig: "
                f"{meta.get('run')} vs {run_payload(self.run)}")

    def load_checkpoint(self, path: str) -> int:
        """Restore a `save_checkpoint` snapshot into this (freshly
        constructed, identically configured) runner; parameters go to the
        runner's device. Returns the next round to execute; `train()`
        continues from there."""
        meta = read_manifest(path)["metadata"]
        self._check_manifest(meta)
        if "stream_cfg" in meta:
            raise ValueError(
                "checkpoint was written by a streaming engine (it carries "
                "in-flight upload state); load it with "
                "repro_torch.fl.stream.StreamEngine.load_checkpoint")
        self._restore_state(restore_tree(path))
        return self.next_round

    def _to_device(self, tree):
        return tree_map(lambda x: torch.from_numpy(np.asarray(x)).to(
            self.device), tree)

    def _restore_state(self, state: dict) -> None:
        self.rng.bit_generator.state = json.loads(
            bytes(np.asarray(state["rng"], np.uint8)).decode())
        self.b_prev = int(state["b_prev"])
        self.next_round = int(state["next_round"])
        if state["gen"]:
            # eq. 48 prices the remaining rounds against the recorded t0
            from repro_torch.gen.calib import MeasuredService
            self.svc = MeasuredService(t_image=float(state["gen"]["t_image"]),
                                       steps=int(state["gen"]["steps"]))
        self.server.params = self._to_device(state["params"])
        logs = state["logs"]
        names = [f.name for f in dataclasses.fields(RoundLog)]
        self.logs = [
            RoundLog(**{n: (int(logs[n][i]) if n in self._LOG_INT_FIELDS
                            else float(logs[n][i])) for n in names})
            for i in range(len(logs["round"]))]
        pool = state["pool"]
        self.server.pool_imgs = (np.asarray(pool["imgs"], np.float32)
                                 if pool else None)
        self.server.pool_labels = (np.asarray(pool["labels"], np.int32)
                                   if pool else None)
        if self.world is not None:
            w = state["world"]
            if not w:
                raise ValueError("checkpoint has no world state but this "
                                 "run uses a persistent scenario")
            a = w["arrays"]
            self.world.state = WorldState(
                vid=np.asarray(a["vid"], np.int64),
                x=np.asarray(a["x"], np.float64),
                v=np.asarray(a["v"], np.float64),
                phi_max=np.asarray(a["phi_max"], np.float64),
                f_mem=np.asarray(a["f_mem"], np.float64),
                f_core=np.asarray(a["f_core"], np.float64),
                v_core=np.asarray(a["v_core"], np.float64),
                shadow_db=np.asarray(a["shadow_db"], np.float64),
                partition=np.asarray(a["partition"], np.int64))
            self.world._free = [int(p) for p in np.asarray(w["free"])]
            self.world._next_vid = int(w["next_vid"])
            st = w["stats"]
            self.world.stats.time = float(st["time"])
            self.world.stats.steps = int(st["steps"])
            self.world.stats.arrivals = int(st["arrivals"])
            self.world.stats.departures = int(st["departures"])
            self.world.stats.blocked_arrivals = int(st["blocked_arrivals"])
            self.world._hists_src = None    # invalidate the hist cache
        stale = state["stale"]
        self.stale = StaleBuffer()
        if stale:
            for i in range(len(stale["size"])):
                self.stale.push(StaleEntry(
                    params=self._to_device(stale["params"][i]),
                    size=int(stale["size"][i]),
                    emd=float(stale["emd"][i]),
                    trained_round=int(stale["trained_round"][i]),
                    vid=int(stale["vid"][i])))
