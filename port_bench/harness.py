"""Set-up, warm-up and the measured window of one cell.

The window drives the program's round loop as a sweep or an RSU does:
`GenFVRunner.begin_round` -> `plan` -> `finish_round`, rounds back to back,
started until the window's seconds have passed; the window ends when the
last round ends. The benchmark makes the data and the weights from the seed
and hands them to the runner; the traffic mix fixes the road.
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch

from port_bench.data import make_datasets
from port_bench.recorder import Recorder, reduce_profile
from port_bench.reference.generators import flat
from port_bench.reference.model import init_params, leaves
from port_bench.spec import constants, generator_block, load_generator


class ConfigMismatch(RuntimeError):
    """The program does not run what the configuration states."""


def build(cell: dict, seed: int, device, timed: bool, phases=None):
    """The runner of the cell on `device`, with the seed's data and weights,
    its world advanced `burn_in_steps` steps of t_max. Returns (runner,
    recorder, train set, test set); the sets are the benchmark's arrays,
    (images NHWC float32, labels int32).

    A configuration with a `generator` block runs that AIGC service, built
    by `program_generator` on the benchmark's weights, and eq. 48 is priced
    with the configuration's diffusion_service (no calibration, so b_gen
    follows the traffic alone). Without the block the runner builds the
    generator `fl.generator` names."""
    from repro_torch.configs.base import GenFVConfig
    from repro_torch.fl import rounds
    from repro_torch.fl.rounds import GenFVRunner, RunConfig

    phases = {} if phases is None else phases
    config, traffic = cell["config"], cell["traffic"]
    ds = config["dataset"]
    t0 = time.perf_counter()
    train, test = make_datasets(ds["name"], ds["classes"], ds["train_size"],
                                ds["test_size"], traffic["world_seed"], seed, device)
    phases["data"] = time.perf_counter() - t0

    def dataset_fn(name, n, seed=0):
        return train if seed == traffic["world_seed"] else test

    fields = set(GenFVConfig.__dataclass_fields__)
    fl_cfg = GenFVConfig(**{k: v for k, v in config["genfv"].items() if k in fields})
    c = constants(config, traffic)
    gen = config.get("generator")
    kinds, svc, generator = {"generator": config["fl"]["generator"]}, None, None
    rec = Recorder(device, timed)
    if gen is not None:
        from repro_torch.core.generation import DiffusionService
        kinds = {"generator": gen["kind"], "sampler_steps": gen["sampler_steps"]}
        svc = DiffusionService(steps=c["diffusion_steps"], d_cycles=c["d_cycles"],
                               f_rsu=c["f_rsu"])
        t0 = time.perf_counter()
        generator = program_generator(generator_block(config), cell["dir"], seed,
                                      traffic["world_seed"], rec, device)
        phases["generator"] = time.perf_counter() - t0
    run = RunConfig(dataset=ds["name"], alpha=config["genfv"]["dirichlet_alpha"],
                    rounds=10_000, strategy=traffic["strategy"],
                    train_size=ds["train_size"], test_size=ds["test_size"],
                    width_mult=config["model"]["width_mult"], seed=traffic["world_seed"],
                    vectorized=config["fl"]["vectorized"], scenario=traffic["scenario"],
                    planner=config["fl"]["planner"], faults=traffic["faults"], **kinds)
    t0 = time.perf_counter()
    runner = GenFVRunner(run, fl_cfg=fl_cfg, dataset_fn=dataset_fn, obs=rec,
                         generator=generator, svc=svc, device=device)
    phases["runner"] = time.perf_counter() - t0

    # the program runs what the configuration states
    wrong = {k: (getattr(runner.cfg, k), c[k]) for k in fields
             if getattr(runner.cfg, k) != c[k]}
    if rounds.CLIENT_LR != config["fl"]["client_lr"] or runner.engine.lr != rounds.CLIENT_LR:
        wrong["client_lr"] = (rounds.CLIENT_LR, config["fl"]["client_lr"])
    params = init_params(config["model"], seed, device)
    shapes = [tuple(x.shape) for x in leaves(params)]
    if [tuple(x.shape) for x in leaves(runner.server.params)] != shapes:
        wrong["model"] = "the program's parameter shapes differ from the configuration's"
    if wrong:
        raise ConfigMismatch(f"program against configuration: {wrong}")
    runner.server.params = params

    t0 = time.perf_counter()
    for _ in range(traffic["burn_in_steps"]):
        runner.world.step(runner.rng, runner.cfg.t_max)
    phases["burn_in"] = time.perf_counter() - t0
    return runner, rec, train, test


#: the keys of a generator block that name the service rather than shape it
BLOCK_NAMES = ("kind", "reference", "sampler_steps", "dataset")
#: keys of a DDPM block that the program's model spec does not hold, which
#: the parameter shapes show
SHAPE_KEYS = ("embed_dim",)


def program_generator(block: dict, here, seed: int, run_seed: int, obs, device):
    """The program's AIGC service as the configuration's generator `block`
    states it, serving the benchmark's weights, which the block's reference
    module (under the benchmark's directory `here`) draws from `seed`: the
    program's own pretraining is not run, since the reference may take no
    weights the program made. The block's keys that the program's model
    spec (`DDPM`) holds configure it. Raises ConfigMismatch where the block
    names another kind or a key the program holds nowhere, or where the
    program's UNet for that spec has other parameter shapes than the
    reference module gives for the block."""
    from repro_torch.diffusion.ddpm import DDPM, make_ddpm
    from repro_torch.gen.service import BatchedDDPMGenerator

    if block["kind"] != "ddpm":
        raise ConfigMismatch(f"the program serves no generator {block['kind']!r} with weights")
    spec = {k: v for k, v in block.items() if k in DDPM.__dataclass_fields__}
    unknown = sorted(set(block) - set(spec) - set(BLOCK_NAMES) - set(SHAPE_KEYS))
    if unknown:
        raise ConfigMismatch(f"the program's DDPM takes no key {unknown}")
    ddpm = DDPM(**spec)
    ref = load_generator(block["reference"], here)
    program = make_ddpm(np.random.default_rng(0), ddpm, device="cpu")
    if {k: tuple(v.shape) for k, v in flat(program).items()} != flat(ref.param_shapes(block)):
        raise ConfigMismatch(f"the program's generator parameter shapes differ from "
                             f"reference {block['reference']!r}'s for the block")
    return BatchedDDPMGenerator(ref.make_params(block, seed, device), ddpm, seed=run_seed,
                                sampler_steps=block["sampler_steps"], obs=obs)


def warm_up(runner, traffic: dict, device) -> None:
    """Run every shape the traffic reaches once: the planner and the fleet
    step at each bucket, the sampler at each of the traffic's sampler
    buckets, omega_a's steps, the evaluation. Nothing of the runner's state
    changes: no random draw, no parameter, no pool."""
    from repro_torch.fl.client import local_sgd_steps
    from repro_torch.fl.rounds import CLIENT_LR, PendingRound

    cfg = runner.cfg
    fleet, parts = runner.world.fleet(runner.hists, runner.sizes)
    params = runner.server.params
    genfv = traffic["strategy"] == "genfv"
    for bucket in traffic["buckets"]:
        k = bucket // 2 + 1
        if len(fleet) < k:
            raise RuntimeError(f"warm-up: a fleet of {len(fleet)} cannot fill bucket {bucket}")
        alpha = np.zeros(len(fleet), np.int32)
        alpha[:k] = 1
        runner.plan(PendingRound(-1, fleet, parts, alpha))
        imgs = np.zeros((cfg.local_steps, cfg.batch_size, 32, 32, 3), np.float32)
        labels = np.zeros((cfg.local_steps, cfg.batch_size), np.int64)
        runner.engine.run(params, [imgs] * k, [labels] * k, np.full(k, 1.0 / k),
                          1.0 if genfv else 0.0, params if genfv else None, guard=False)
    for bucket in traffic.get("sampler_buckets", ()):
        # the round-keyed sampler draws from no stream of the runner's
        runner.server.generator.generate(np.zeros(bucket, np.int32), None, round_idx=0)
    if genfv:
        steps = cfg.local_steps * cfg.rsu_steps_factor
        local_sgd_steps(params, runner.cnn_cfg,
                        torch.zeros(steps, cfg.batch_size, 3, 32, 32, device=device),
                        torch.zeros(steps, cfg.batch_size, dtype=torch.int64, device=device),
                        steps, CLIENT_LR)
    runner.evaluate()
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(runner, rec: Recorder, seconds: float, cycle: int, profile_rounds=()):
    """Rounds back to back until `seconds` have passed. Every `cycle`
    rounds the road starts over: the world and the random stream return to
    where the window found them, so the window replays one segment of
    traffic (the same fleets, selections and batch draws) while the model
    trains on; how many rounds a run completes then changes which rounds
    it averages only within a segment. Each round's record keeps what the
    output check and the metric readers need: among them omega_a and the
    mean loss of its steps, noted as the server hands them back. With
    `profile_rounds`, torch.profiler records the device's kernels over
    those rounds (CUDA activity only: recording the host's operations too
    would slow the host-bound stages it measures). A round that generates
    keeps the images it added to the pool ("gen")."""
    rounds = []
    cur = {}

    def note(key):
        def hook():
            cur[key] = runner.rng.bit_generator.state
        return hook

    rec.hooks = {"round/select": note("rng_select"), "round/generate": note("rng_generate"),
                 "round/local_sgd": note("rng_local_sgd")}
    rec.exit_hooks = {"round/generate": lambda sp: cur.update(aug=sp.sync)}
    server = runner.server
    train_augmented = server.train_augmented

    def noted_train_augmented(*args, **kwargs):
        # omega_a's mean step loss, which the runner keeps only without FL
        aug, loss = train_augmented(*args, **kwargs)
        cur["aug_loss"] = loss
        return aug, loss
    server.train_augmented = noted_train_augmented
    prof, done, marker = None, None, 0.0
    road = (copy.deepcopy(runner.world), runner.rng.bit_generator.state)
    t0 = time.perf_counter()
    t = 0
    while True:
        if t and t % cycle == 0:
            runner.world = copy.deepcopy(road[0])
            runner.rng.bit_generator.state = road[1]
        if (t in profile_rounds and prof is None and done is None
                and rec.device.type == "cuda"):
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            rec.sync()
            marker = time.perf_counter()
            torch.cuda._sleep(1000)       # ties the host clock to the device's
            rec.sync()
            rec.intervals = []
        cur = {"t": t, "b_prev": runner.b_prev, "p0": runner.server.params,
               "pool_n": 0 if runner.server.pool_labels is None
               else len(runner.server.pool_labels)}
        rec.ms = {} if rec.timed else None
        r0 = time.perf_counter()
        pending = runner.begin_round(t)
        plan = runner.plan(pending)
        log = runner.finish_round(pending, plan)
        r1 = time.perf_counter()
        pool = runner.server.pool_imgs
        cur.update(wall_ms=1e3 * (r1 - r0), pending=pending, plan=plan,
                   log=log, p1=runner.server.params, ms=rec.ms,
                   profiled=prof is not None,
                   gen=None if pool is None else pool[cur["pool_n"]:].copy())
        if rec.intervals is not None:
            rec.intervals.append(("round", r0, r1))
        rounds.append(cur)
        t += 1
        if prof is not None and (t not in profile_rounds
                                 or time.perf_counter() - t0 >= seconds):
            prof.stop()
            done, prof, intervals, rec.intervals = prof, None, rec.intervals, None
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    rec.hooks, rec.exit_hooks, rec.ms = {}, {}, None
    del server.train_augmented
    return rounds, window_s, ({} if done is None
                              else reduce_profile(done, intervals, marker))
