"""Batched device planner: the SUBP2-4 BCD of Algorithm 3 in torch float64
on the device the caller names, over one or many fleets at once.

This is `planner="torch"`, the counterpart of the JAX package's
`planner="jax"` (`repro/core/planner.py`); `planner="numpy"` keeps the host
reference solvers (`core/{bandwidth,power,two_scale}.py`). The structure
follows the JAX kernel:

* every loop keeps the iteration structure and float-op order of the numpy
  solvers, in float64;
* selected sets are padded to the power-of-two bucket shared with the fleet
  engine (`bucket_size`, floor 4); padded slots carry zero subcarriers and
  False validity and cannot move the result;
* every loop state is **done-guarded**: once a lane has converged its
  state freezes, so extra iterations are exact no-ops. Many fleets are
  planned as rows of one [F, Kp] batch, and a row's result is bitwise the
  result of planning that fleet alone.

Where the JAX kernel runs `lax.while_loop`s on the device, a torch loop
must ask the host whether to go on, and each such read waits for the
device. Because a done lane is a no-op, the body is stepped `SYNC_EVERY`
times between two reads of the done flags: one sync per `SYNC_EVERY`
iterations, and at most `SYNC_EVERY - 1` iterations more than the loop
needs. The budget projection inside each bandwidth iteration runs one
guarded step (the projection ends in one step unless an entry falls below
the floor); if any lane needed more, the chunk is stepped again from its
start with all `Kp` projection steps the JAX loop allows.

The host knows how many loop bodies it issues: `RoundPlan.steps` counts
them by part (single-projection bandwidth steps, the redo's
full-projection steps, SCA power steps), and with a tracer the BCD's
subproblems open spans of their own (`round/plan/bandwidth`,
`round/plan/power`, `round/plan/generation`, `round/plan/ledger`). Neither
reads the device nor launches anything.

Sums over the fleet axis are pairwise over the padded power-of-two axis
(`_tree_sum`), written as elementwise adds: their order does not depend on
the batch, the device or the bucket (padding adds exact zeros first).
Divisions by a constant divide by a 0-d device tensor, because CUDA turns a
division by a host scalar into a multiplication by its reciprocal.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.configs.base import GenFVConfig
from repro_torch.core import channel, gpu_model
from repro_torch.core.generation import DiffusionService
from repro_torch.core.gpu_model import CONSTS, RSU_F_CORE, RSU_SPEEDUP
from repro_torch.core.mobility import Vehicle, rsu_distances
from repro_torch.core.selection import SelectionResult, select
from repro_torch.models.api import resolve_device
from repro_torch.obs import NULL_OBS

LN2 = float(np.log(2.0))

#: loop bodies stepped between two host reads of a loop's done flags
SYNC_EVERY = 8


# ---------------------------------------------------------------------------
# Fleet-size bucketing (shared with fl/fleet.py).
# ---------------------------------------------------------------------------
def bucket_size(k: int, min_bucket: int = 4, max_bucket: int = 4096) -> int:
    """Smallest power-of-two >= k (clamped to [min_bucket, max_bucket]),
    the JAX package's bucket scheme."""
    if k > max_bucket:
        raise ValueError(f"fleet of {k} exceeds max bucket {max_bucket}")
    b = max(int(min_bucket), 1)
    while b < k:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# Round plan.
# ---------------------------------------------------------------------------
@dataclass
class RoundPlan:
    alpha: np.ndarray                 # [N] selection indicator
    selected: List[int]               # indices with alpha=1
    l: np.ndarray                     # [K] subcarriers per selected vehicle
    phi: np.ndarray                   # [K] tx power per selected vehicle
    b_gen: int                        # images to generate (SUBP4)
    t_cp: np.ndarray                  # [K] per-vehicle training delay
    t_mu: np.ndarray                  # [K] per-vehicle upload delay
    t_bar: float                      # max_n (t_cp + t_mu) — system delay
    e_total: np.ndarray               # [K] per-vehicle energy
    t_rsu: float                      # RSU generation + augmentation time
    bcd_iters: int = 0
    # BCD stopped before its iteration cap (`bcd_iters < max_bcd`, shared
    # by both backends; conservative when convergence lands exactly on the
    # final allowed iteration).
    converged: bool = True
    history: List[float] = field(default_factory=list)   # T_bar per BCD iter
    selection: SelectionResult | None = None
    # host reads of the device planner's done flags and result (0 for numpy)
    syncs: int = 0
    # loop bodies the device planner issued, by part: "bandwidth" (one-step
    # projections), "bandwidth_redo" (all-Kp projections), "power" (SCA);
    # empty for numpy
    steps: dict = field(default_factory=dict)


def empty_plan(alpha: np.ndarray,
               sel: SelectionResult | None = None) -> RoundPlan:
    """The no-vehicle-selected plan (shared by both planner backends)."""
    return RoundPlan(alpha, [], np.zeros(0), np.zeros(0), 0,
                     np.zeros(0), np.zeros(0), 0.0, np.zeros(0), 0.0,
                     selection=sel)


# ---------------------------------------------------------------------------
# Per-selected-vehicle constants (shared by the numpy and torch backends).
# ---------------------------------------------------------------------------
class SelectedConsts(NamedTuple):
    t_cp: np.ndarray       # [K] eq. 6 training delay (A in Alg. 1)
    e_cp: np.ndarray       # [K] eq. 8 training energy (C in Alg. 1 / G)
    b_prime: np.ndarray    # [K] shadowed channel gain over noise
    phi_max: np.ndarray    # [K] per-vehicle power cap


def selected_consts(cfg: GenFVConfig, fleet: Sequence[Vehicle],
                    idx: Sequence[int], batches: int) -> SelectedConsts:
    """Constants of the BCD given a selected index set (hoisted out of the
    iteration: they do not change across SUBP2/3/4 passes)."""
    xs = np.array([fleet[i].x for i in idx], np.float64)
    f_mem = np.array([fleet[i].f_mem for i in idx], np.float64)
    f_core = np.array([fleet[i].f_core for i in idx], np.float64)
    v_core = np.array([fleet[i].v_core for i in idx], np.float64)
    gain_db = np.array([fleet[i].gain_db for i in idx], np.float64)
    phi_max = np.array([fleet[i].phi_max for i in idx], np.float64)

    dists = rsu_distances(cfg, xs)
    t_cp = gpu_model.train_times(f_mem, f_core, batches)
    e_cp = gpu_model.runtime_powers(f_mem, f_core, v_core) * t_cp
    n0 = channel.noise_watts(cfg)
    shadow = channel.shadow_linear(gain_db)
    b_prime = (cfg.unit_channel_gain * shadow
               * dists ** (-cfg.path_loss_exp) / n0)
    return SelectedConsts(t_cp, e_cp, b_prime, phi_max)


class PlannerConsts(NamedTuple):
    model_bits: float
    M: float               # num_subcarriers
    W: float               # subcarrier_bw
    e_bar: float           # e_max
    phi_min: float
    t_max: float
    l_min: float
    bw_step: float
    bw_tol: float
    bw_max_iter: int
    sca_eps: float
    sca_max_iter: int
    bcd_eps: float
    gen_batch: int
    t_per_image: float     # eq. 12 t0
    g_t0: float            # rsu_train_time pieces (eq. 13)
    g_c1: float
    g_theta_mem: float
    g_c2: float
    g_theta_core: float
    rsu_denom: float       # 1.5e9 * speedup


def planner_consts(cfg: GenFVConfig, model_bits: float,
                   svc: DiffusionService, eps: float) -> PlannerConsts:
    g = CONSTS
    return PlannerConsts(
        model_bits=float(model_bits), M=float(cfg.num_subcarriers),
        W=float(cfg.subcarrier_bw), e_bar=float(cfg.e_max),
        phi_min=float(cfg.phi_min), t_max=float(cfg.t_max),
        l_min=float(cfg.bw_l_min), bw_step=float(cfg.bw_step),
        bw_tol=float(cfg.bw_tol), bw_max_iter=int(cfg.bw_max_iter),
        sca_eps=float(cfg.sca_eps), sca_max_iter=int(cfg.sca_max_iter),
        bcd_eps=float(eps), gen_batch=int(cfg.gen_batch),
        t_per_image=float(svc.t_per_image),
        g_t0=float(g.t0), g_c1=float(g.c1), g_theta_mem=float(g.theta_mem),
        g_c2=float(g.c2), g_theta_core=float(g.theta_core),
        rsu_denom=float(RSU_F_CORE * RSU_SPEEDUP))


@lru_cache(maxsize=64)
def _device_consts(c: PlannerConsts, device: torch.device) -> PlannerConsts:
    """The float constants as 0-d float64 tensors on `device` (the integer
    caps stay Python ints): one upload per (config, device), and divisions
    by them stay true divisions."""
    return PlannerConsts(*(v if isinstance(v, int) else
                           torch.tensor(v, dtype=torch.float64, device=device)
                           for v in c))


# ---------------------------------------------------------------------------
# The kernel: F fleets, padded arrays [F, Kp], valid mask [F, Kp].
# ---------------------------------------------------------------------------
def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two) in a fixed pairwise order."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _project_budget(c: PlannerConsts, l, valid, steps: int):
    """bandwidth.project_budget with masked padding (pads hold l=0): `steps`
    done-guarded water-filling steps. Returns (l, done [F])."""
    pinned = torch.zeros_like(valid)
    done = torch.zeros(l.shape[0], dtype=torch.bool, device=l.device)
    for _ in range(steps):
        free = valid & ~pinned
        s_pin = c.l_min * _tree_sum((valid & pinned).to(l.dtype))
        s_free = _tree_sum(torch.where(free, l, 0.0))
        need = s_pin + s_free > c.M
        scale = (torch.clamp(c.M - s_pin, min=0.0)
                 / torch.clamp(s_free, min=1e-300))
        l_sc = torch.where(free, l * scale[:, None],
                           torch.where(valid, c.l_min, 0.0))
        newly = free & (l_sc < c.l_min)
        l_new = torch.where(newly, c.l_min, l_sc)
        hold = (done | ~need)[:, None]
        l = torch.where(hold, l, l_new)
        pinned = torch.where(hold, pinned, pinned | newly)
        done = done | ~need | ~newly.any(-1)
    return l, done


def _bandwidth_step(c: PlannerConsts, st, B, D, t_cp, e_cp, valid, n_val,
                    proj_steps: int):
    """One done-guarded iteration of Algorithm 1 (eq. 33-38). Returns the
    new state and the lanes whose projection needed more steps."""
    lam1, lam2, lam3, l, prev, it, done = st
    l_n = torch.sqrt((lam1 * B + lam2[:, None] * D)
                     / torch.clamp(lam3, min=1e-9)[:, None])
    l_n = torch.where(valid, torch.clamp(l_n, c.l_min, c.M), 0.0)
    l_n, p_done = _project_budget(c, l_n, valid, proj_steps)
    l_safe = torch.where(valid, l_n, 1.0)
    delay = torch.where(valid, t_cp + B / l_safe, -torch.inf)
    t_bar = delay.amax(-1)
    g1 = torch.where(valid, delay - t_bar[:, None], 0.0)
    g2 = (_tree_sum(torch.where(valid, e_cp + D / l_safe, 0.0))
          - c.e_bar * n_val)
    g3 = _tree_sum(l_n) - c.M
    lam1_n = torch.clamp(lam1 + c.bw_step * g1, min=0.0) + 1e-12
    lam2_n = torch.clamp(lam2 + c.bw_step * g2, min=0.0) + 1e-12
    lam3_n = torch.clamp(lam3 + c.bw_step * g3, min=1e-6)
    conv = (l_n - prev).abs().amax(-1) < c.bw_tol
    it_n = it + 1
    d2 = done[:, None]
    st = (torch.where(d2, lam1, lam1_n), torch.where(done, lam2, lam2_n),
          torch.where(done, lam3, lam3_n), torch.where(d2, l, l_n),
          torch.where(d2, prev, l_n), torch.where(done, it, it_n),
          done | conv | (it_n >= c.bw_max_iter))
    return st, ~done & ~p_done


def _solve_bandwidth(c: PlannerConsts, B, D, t_cp, e_cp, valid, n_val,
                     done, read, steps):
    """Algorithm 1 for the lanes not yet `done`; `read` fetches a flag, and
    `steps` counts the steps issued."""
    l0 = torch.where(valid, c.M / n_val[:, None], 0.0)
    ones = torch.ones_like(n_val)
    st = (torch.ones_like(l0), ones, ones, l0, l0,
          torch.zeros_like(n_val, dtype=torch.int64), done)
    kp = valid.shape[-1]
    while True:
        start = st
        short = torch.zeros_like(done)
        for _ in range(SYNC_EVERY):
            st, s = _bandwidth_step(c, st, B, D, t_cp, e_cp, valid, n_val, 1)
            short = short | s
        steps["bandwidth"] += SYNC_EVERY
        all_done, redo = read(torch.stack([st[6].all(), short.any()]))
        if redo:
            st = start
            for _ in range(SYNC_EVERY):
                st, _ = _bandwidth_step(c, st, B, D, t_cp, e_cp, valid,
                                        n_val, kp)
            steps["bandwidth_redo"] += SYNC_EVERY
            all_done = read(st[6].all())
        if all_done:
            return st[3]


def _power_step(c: PlannerConsts, st, a, lw_s, bp_s, e_cp, phi_max, valid):
    """One done-guarded SCA iteration of Algorithm 2 (eq. 39-46)."""
    phi, it, done = st
    u = bp_s * phi
    log2u = torch.log2(1.0 + u)
    e_i = phi * (c.model_bits / (lw_s * log2u))
    de = a / log2u - a * bp_s * phi / (LN2 * (1.0 + u) * log2u ** 2)
    slack = c.e_bar - e_cp - e_i
    phi_b = torch.where(de > 1e-12, phi + slack / de, phi_max)
    phi_n = torch.minimum(torch.clamp(torch.minimum(phi_b, phi_max),
                                      min=c.phi_min), phi_max)
    conv = torch.where(valid, (phi_n - phi).abs(), 0.0).amax(-1) < c.sca_eps
    it_n = it + 1
    return (torch.where(done[:, None], phi, phi_n), torch.where(done, it, it_n),
            done | conv | (it_n >= c.sca_max_iter))


def _solve_power(c: PlannerConsts, l_w, b_prime, e_cp, phi_max, valid, done,
                 read, steps):
    """Algorithm 2 for the lanes not yet `done`."""
    lw_s = torch.where(valid, l_w, 1.0)
    bp_s = torch.where(valid, b_prime, 1.0)
    a = c.model_bits / lw_s
    st = (torch.full_like(l_w, 1.0) * c.phi_min,
          torch.zeros(done.shape, dtype=torch.int64, device=done.device), done)
    while True:
        for _ in range(SYNC_EVERY):
            st = _power_step(c, st, a, lw_s, bp_s, e_cp, phi_max, valid)
        steps["power"] += SYNC_EVERY
        if read(st[2].all()):
            return st[0]


def _rsu_train_time(c: PlannerConsts, bt):
    """Eq. 13 (gpu_model.rsu_train_time) for bt augmented batches."""
    return c.g_t0 + (c.g_c1 * bt * c.g_theta_mem
                     + c.g_c2 * bt * c.g_theta_core) / c.rsu_denom


def _optimal_generation(c: PlannerConsts, t_bar, b_prev):
    """Eq. 48 closed form (generation.optimal_generation)."""
    bt = torch.clamp(b_prev // c.gen_batch, min=1).to(t_bar.dtype)
    budget = torch.minimum(t_bar, c.t_max) - _rsu_train_time(c, bt)
    return torch.where(budget > 0.0, torch.floor(budget / c.t_per_image),
                       0.0).to(b_prev.dtype)


def _bcd_kernel(c: PlannerConsts, t_cp, e_cp, b_prime, phi_max, valid,
                b_prev, ks: Sequence[int], max_bcd: int, obs=NULL_OBS):
    """Algorithm 3's small computation scale for F padded fleets [F, Kp]
    whose first `ks[f]` slots are valid. Returns each fleet's ledger (see
    `_unpack`), the number of host reads and the loop bodies issued by
    part. Each BCD iteration opens a span per subproblem on `obs`, and the
    final read of the ledger one more."""
    reads = [0]
    steps = {"bandwidth": 0, "bandwidth_redo": 0, "power": 0}

    def read(t):
        reads[0] += 1
        return t.tolist()

    n_val = _tree_sum(valid.to(t_cp.dtype))
    bp_s = torch.where(valid, b_prime, 1.0)

    def t_mu_of(l, phi):
        lw_s = torch.where(valid, l * c.W, 1.0)
        return c.model_bits / (lw_s * torch.log2(1.0 + bp_s * phi))

    l = torch.where(valid, c.M / n_val[:, None], 0.0)
    phi = torch.where(valid, phi_max, 0.0)
    b = b_prev
    it = torch.zeros_like(b_prev)
    done = torch.full_like(valid[:, 0], max_bcd <= 0)
    hist = torch.zeros((valid.shape[0], max(max_bcd, 1)), dtype=t_cp.dtype,
                       device=t_cp.device)
    slot = torch.arange(hist.shape[1], device=t_cp.device)[None]
    bcd_iter = 0
    while max_bcd > 0:
        tags = {"bcd_iter": bcd_iter} if obs.enabled else {}
        bcd_iter += 1
        # SUBP2: bandwidth given phi, b
        with obs.span("round/plan/bandwidth", **tags):
            rate1 = c.W * torch.log2(1.0 + bp_s * phi)
            B = torch.where(valid, c.model_bits / rate1, 0.0)
            D = torch.where(valid, phi * B, 0.0)
            l_n = _solve_bandwidth(c, B, D, t_cp, e_cp, valid, n_val, done,
                                   read, steps)
        # SUBP3: power given l, b
        with obs.span("round/plan/power", **tags):
            phi_n = _solve_power(c, l_n * c.W, b_prime, e_cp, phi_max, valid,
                                 done, read, steps)
        # SUBP4: generation given l, phi (closed form, eq. 48)
        with obs.span("round/plan/generation", **tags):
            t_mu = t_mu_of(l_n, phi_n)
            t_bar = torch.where(valid, t_cp + t_mu, -torch.inf).amax(-1)
            b_n = _optimal_generation(c, t_bar, b)
            hist_n = torch.where(slot == it[:, None], t_bar[:, None], hist)
            conv = ((torch.where(valid, (l_n - l).abs(), 0.0).amax(-1)
                     < c.bcd_eps)
                    & (torch.where(valid, (phi_n - phi).abs(), 0.0).amax(-1)
                       < c.bcd_eps)
                    & ((b_n - b).abs() < 1))
            it_n = it + 1
            d2 = done[:, None]
            l, phi = torch.where(d2, l, l_n), torch.where(d2, phi, phi_n)
            b, it = torch.where(done, b, b_n), torch.where(done, it, it_n)
            hist = torch.where(d2, hist, hist_n)
            done = done | conv | (it_n >= max_bcd)
            stop = read(done.all())
        if stop:
            break

    # final ledger (mirrors the tail of the numpy plan_round)
    with obs.span("round/plan/ledger"):
        t_mu = torch.where(valid, t_mu_of(l, phi), 0.0)
        e_mu = phi * t_mu
        t_bar = torch.where(valid, t_cp + t_mu, -torch.inf).amax(-1)
        bt = torch.clamp(b // c.gen_batch, min=1).to(t_cp.dtype)
        t_rsu = b.to(t_cp.dtype) * c.t_per_image + _rsu_train_time(c, bt)
        col = lambda x: x.to(t_cp.dtype)[:, None]             # noqa: E731
        out = torch.cat([l, phi, t_mu, e_mu, col(t_bar), col(t_rsu), col(b),
                         col(it), hist], dim=1)
        reads[0] += 1
        out = out.cpu().numpy()
        kp = valid.shape[-1]
        rows = [_unpack(out[i], k, kp, max_bcd) for i, k in enumerate(ks)]
    return rows, reads[0], steps


def _unpack(row: np.ndarray, k: int, kp: int, max_bcd: int) -> dict:
    l, phi, t_mu, e_mu = (row[i * kp:i * kp + k] for i in range(4))
    t_bar, t_rsu, b, it = row[4 * kp:4 * kp + 4]
    iters = int(it)
    hist = row[4 * kp + 4:]
    return dict(l=l.copy(), phi=phi.copy(), b_gen=int(b), t_mu=t_mu.copy(),
                e_mu=e_mu.copy(), t_bar=float(t_bar), t_rsu=float(t_rsu),
                bcd_iters=iters, converged=iters < max_bcd,
                history=[float(h) for h in hist[:iters]])


def _pad(x: np.ndarray, kp: int, fill: float = 0.0) -> np.ndarray:
    x = np.asarray(x, np.float64)
    if len(x) == kp:
        return x
    return np.concatenate([x, np.full(kp - len(x), fill)])


def _run(cfg, model_bits, svc, eps, max_bcd, consts_list, ks, kp, b_prevs,
         device, obs):
    """Pad, upload, run the kernel over the fleets and unpack each row."""
    if kp & (kp - 1):
        raise ValueError(f"bucket {kp} is not a power of two")
    device = resolve_device(device)
    c = _device_consts(planner_consts(cfg, model_bits, svc, eps), device)
    valid = np.zeros((len(ks), kp), bool)
    for row, k in enumerate(ks):
        valid[row, :k] = True

    def stack(get, fill=0.0):
        rows = np.stack([_pad(get(s), kp, fill) for s in consts_list])
        return torch.from_numpy(rows).to(device)

    return _bcd_kernel(
        c, stack(lambda s: s.t_cp), stack(lambda s: s.e_cp),
        stack(lambda s: s.b_prime), stack(lambda s: s.phi_max, cfg.phi_min),
        torch.from_numpy(valid).to(device),
        torch.tensor(list(b_prevs), dtype=torch.int64, device=device),
        ks, int(max_bcd), obs)


def plan_selected_torch(cfg: GenFVConfig, model_bits: float,
                        consts: SelectedConsts, b_prev: int,
                        svc: DiffusionService, eps: float, max_bcd: int,
                        bucket: int | None = None, device="cuda",
                        obs=NULL_OBS) -> dict:
    """Run the BCD for one already-selected fleet on `device`. Returns the
    ledger arrays (trimmed to K) for RoundPlan assembly, the number of
    host reads under "syncs" and the loop bodies issued under "steps".
    `bucket` overrides the power-of-two padding (tests use it to show the
    padding is neutral); `obs` takes the BCD's spans."""
    k = len(consts.t_cp)
    kp = bucket_size(k) if bucket is None else int(bucket)
    if kp < k:
        raise ValueError(f"bucket {kp} smaller than fleet {k}")
    rows, reads, steps = _run(cfg, model_bits, svc, eps, max_bcd, [consts],
                              [k], kp, [int(b_prev)], device, obs)
    return dict(rows[0], syncs=reads, steps=steps)


def plan_rounds_batched(cfg: GenFVConfig, fleets: Sequence[Sequence[Vehicle]],
                        model_bits: float, batches: int,
                        b_prevs: Sequence[int] | None = None,
                        alpha_overrides: Sequence[np.ndarray | None] | None
                        = None,
                        svc: DiffusionService | None = None,
                        eps: float | None = None,
                        max_bcd: int | None = None,
                        device="cuda", obs=NULL_OBS) -> List[RoundPlan]:
    """Plan many independent fleets as the rows of one batch on `device`.

    Fleets may differ in size and selected-set size; all selected sets are
    padded to a common power-of-two bucket. Each plan is bitwise the plan
    `plan_round(..., planner="torch")` makes for that fleet alone (the
    done-guarded loops freeze converged rows). `syncs` and `steps` of each
    plan are the batch's counts of host reads and loop bodies; `obs` takes
    the batch's BCD spans.
    """
    svc = svc or DiffusionService(steps=cfg.diffusion_steps)
    eps = cfg.bcd_eps if eps is None else eps
    max_bcd = cfg.bcd_max_iter if max_bcd is None else max_bcd
    n_fleet = len(fleets)
    b_prevs = [0] * n_fleet if b_prevs is None else list(b_prevs)
    overrides = ([None] * n_fleet if alpha_overrides is None
                 else list(alpha_overrides))

    sels, alphas, idxs, consts = [], [], [], []
    for fleet, ov in zip(fleets, overrides):
        if ov is None:
            sel = select(cfg, fleet, model_bits, batches)
            alpha = sel.alpha
        else:
            sel = None
            alpha = np.asarray(ov)
        idx = [i for i in range(len(fleet)) if alpha[i] == 1]
        sels.append(sel)
        alphas.append(alpha)
        idxs.append(idx)
        consts.append(selected_consts(cfg, fleet, idx, batches))

    live = [f for f in range(n_fleet) if idxs[f]]
    plans: List[RoundPlan | None] = [None] * n_fleet
    for f in range(n_fleet):
        if f not in live:
            plans[f] = empty_plan(alphas[f], sels[f])
    if not live:
        return plans

    kp = bucket_size(max(len(idxs[f]) for f in live))
    rows, reads, steps = _run(cfg, model_bits, svc, eps, max_bcd,
                              [consts[f] for f in live],
                              [len(idxs[f]) for f in live], kp,
                              [b_prevs[f] for f in live], device, obs)
    for r, f in zip(rows, live):
        s = consts[f]
        plans[f] = RoundPlan(
            alpha=alphas[f], selected=idxs[f], l=r["l"], phi=r["phi"],
            b_gen=r["b_gen"], t_cp=s.t_cp, t_mu=r["t_mu"],
            t_bar=r["t_bar"], e_total=s.e_cp + r["e_mu"], t_rsu=r["t_rsu"],
            bcd_iters=r["bcd_iters"], converged=r["converged"],
            history=r["history"], selection=sels[f], syncs=reads,
            steps=dict(steps))
    return plans
