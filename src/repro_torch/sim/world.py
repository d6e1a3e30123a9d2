"""Persistent vectorized vehicular world (paper Sec. V-A2 made stateful).

The seed redrew an i.i.d. fleet from scratch every round
(`core/mobility.py::sample_fleet`): no vehicle persisted between rounds, no
one ever left coverage mid-round, and the channel was memoryless — the
velocity-aware SUBP1 selection policy was never actually stressed. This
module keeps a struct-of-arrays world that the FL runner steps once per
round:

* **Arrivals** — Poisson process at the two coverage edges (eastbound
  vehicles enter at x=-sqrt(r^2-e^2), westbound at +sqrt(r^2-e^2)), with
  the entry jitter spread over the step so a long step does not pile
  arrivals on the boundary.
* **Departures** — a vehicle whose position exits the coverage chord is
  removed and releases its data-partition binding.
* **Speeds** — eq. 24 road-load feedback: the per-step target speed is
  v_bar(M) for the *current* on-road count M (bound and unbound vehicles
  alike congest the road), and individual speeds follow an AR(1) pull
  toward it with the truncated-normal noise of the memoryless model.
* **Shadowing** — per-vehicle AR(1) log-normal shadowing (dB domain) with
  stationary std `cfg.shadow_sigma_db` and decorrelation time
  `cfg.shadow_corr_time`, so SNR evolves coherently with distance between
  rounds instead of being redrawn.
* **Data binding** — each vehicle holds at most one Dirichlet data
  partition for its whole residency; arrivals draw a random free partition
  (blocked arrivals stay on the road as pure traffic), departures return
  theirs to the pool.

All state lives in flat numpy arrays and every update is vectorized, so a
world step is O(N) numpy work with no per-vehicle Python in the hot loop.
RNG is consumed in a FIXED order per step (speed noise -> shadowing noise
-> arrival count -> arrival attributes -> partition draws); the port's
bitwise parity with the JAX package's world relies on this.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import GenFVConfig
from repro_torch.core import mobility
from repro_torch.core.emd import emd_many
from repro_torch.core.mobility import Vehicle
from repro_torch.sim.scenarios import Scenario


@dataclass
class WorldStats:
    """Cumulative counters since world construction."""
    time: float = 0.0            # simulated seconds
    steps: int = 0
    arrivals: int = 0
    departures: int = 0
    blocked_arrivals: int = 0    # arrived with no free data partition


@dataclass
class WorldState:
    """Struct-of-arrays snapshot of the live fleet (all arrays [N])."""
    vid: np.ndarray        # int64 persistent vehicle ids
    x: np.ndarray          # signed position along the road (m), 0 = RSU foot
    v: np.ndarray          # signed speed (km/h); sign = direction
    phi_max: np.ndarray    # max uplink tx power (W)
    f_mem: np.ndarray      # GPU memory frequency (Hz)
    f_core: np.ndarray     # GPU core frequency (Hz)
    v_core: np.ndarray     # GPU core voltage (V)
    shadow_db: np.ndarray  # AR(1) shadowing state on h0 (dB)
    partition: np.ndarray  # int64 bound data-partition index, -1 = unbound

    @property
    def n(self) -> int:
        return len(self.x)


class VehicularWorld:
    """The persistent world. `step(rng, dt)` advances it; `fleet(...)` views
    the data-bound vehicles as `core.mobility.Vehicle`s for SUBP1-4."""

    def __init__(self, cfg: GenFVConfig, scenario: Scenario,
                 n_partitions: int, rng: np.random.Generator):
        self.cfg = cfg
        self.scenario = scenario
        self.n_partitions = int(n_partitions)
        self.stats = WorldStats()
        self._next_vid = 0
        self._hists_src = None   # per-partition histogram/EMD cache, keyed
        self._hists64 = None     # on the hists object identity (fleet())
        self._emds = None

        half = mobility.coverage_half_length(cfg)
        mean0 = scenario.init_mean if scenario.init_mean is not None \
            else cfg.num_vehicles
        n0 = max(int(rng.poisson(mean0)), 1)
        x = rng.uniform(-half, half, size=n0)
        dirs = np.where(rng.random(n0) < scenario.direction_split, 1.0, -1.0)
        speeds = mobility.sample_speeds(rng, cfg, n0, m_on_road=n0)
        caps = self._draw_capabilities(rng, n0)
        shadow = rng.normal(0.0, cfg.shadow_sigma_db, size=n0)
        # initial binding: a random subset of partitions, one per vehicle
        perm = rng.permutation(self.n_partitions)
        nb = min(n0, self.n_partitions)
        part = np.full(n0, -1, np.int64)
        part[:nb] = perm[:nb]
        self._free: List[int] = [int(p) for p in perm[nb:]]

        self.state = WorldState(
            vid=np.arange(n0, dtype=np.int64), x=x, v=speeds * dirs,
            phi_max=caps[0], f_mem=caps[1], f_core=caps[2], v_core=caps[3],
            shadow_db=shadow, partition=part)
        self._next_vid = n0

    # ------------------------------------------------------------------
    def _draw_capabilities(self, rng: np.random.Generator, n: int):
        s, cfg = self.scenario, self.cfg
        return (rng.uniform(cfg.phi_min, cfg.phi_max, size=n),
                rng.uniform(*s.gpu_f_mem, size=n),
                rng.uniform(*s.gpu_f_core, size=n),
                rng.uniform(*s.gpu_v_core, size=n))

    # ------------------------------------------------------------------
    def step(self, rng: np.random.Generator, dt: float) -> None:
        """Advance the world by `dt` seconds (one FL round).

        RNG consumption order is fixed: (1) speed innovations, (2) shadowing
        innovations for survivors, (3) arrival count, (4) arrival attributes,
        (5) one partition draw per bindable arrival.
        """
        cfg, scn, st = self.cfg, self.scenario, self.state
        half = mobility.coverage_half_length(cfg)
        n = st.n

        # (1) eq.-24 road-load speed feedback + AR(1) individual speeds
        v_bar = mobility.average_speed(cfg, n)
        sigma = cfg.sigma_k * v_bar
        rho_v = float(np.clip(scn.speed_corr, 0.0, 1.0))
        eps_v = rng.normal(size=n)
        speed = np.abs(st.v)
        speed = (rho_v * speed + (1.0 - rho_v) * v_bar
                 + sigma * np.sqrt(1.0 - rho_v ** 2) * eps_v)
        speed = np.clip(speed, cfg.v_min, cfg.v_max)
        sign = np.where(st.v >= 0.0, 1.0, -1.0)
        v = sign * speed

        # positions advance, then out-of-chord vehicles depart
        x = st.x + v / 3.6 * dt
        keep = np.abs(x) <= half
        gone = np.flatnonzero(~keep)
        if gone.size:
            released = st.partition[gone]
            self._free.extend(int(p) for p in released if p >= 0)
            self.stats.departures += int(gone.size)
        vid = st.vid[keep]
        x, v = x[keep], v[keep]
        phi, fm = st.phi_max[keep], st.f_mem[keep]
        fc, vc = st.f_core[keep], st.v_core[keep]
        part = st.partition[keep]

        # (2) AR(1) shadowing for survivors (stationary N(0, sigma_db^2))
        shadow = st.shadow_db[keep]
        if cfg.shadow_corr_time > 0.0:
            rho_s = float(np.exp(-dt / cfg.shadow_corr_time))
        else:
            rho_s = 0.0
        eps_s = rng.normal(size=len(shadow))
        shadow = (rho_s * shadow
                  + cfg.shadow_sigma_db * np.sqrt(1.0 - rho_s ** 2) * eps_s)

        # (3-5) Poisson arrivals at the coverage edges
        k = int(rng.poisson(cfg.arrival_rate * dt))
        if k > 0:
            dirs = np.where(rng.random(k) < scn.direction_split, 1.0, -1.0)
            u = rng.uniform(0.0, 1.0, size=k)   # fraction of dt already in
            sp = mobility.sample_speeds(rng, cfg, k, m_on_road=len(x) + k)
            v_new = sp * dirs
            x_new = np.clip(-dirs * half + v_new / 3.6 * dt * u, -half, half)
            caps = self._draw_capabilities(rng, k)
            sh_new = rng.normal(0.0, cfg.shadow_sigma_db, size=k)
            # only the first min(k, |free|) arrivals can bind (pops only
            # shrink the pool), so the loop — and its rng draws — stop there
            p_new = np.full(k, -1, np.int64)
            nb = min(k, len(self._free))
            for i in range(nb):
                j = int(rng.integers(len(self._free)))
                p_new[i] = self._free.pop(j)
            self.stats.blocked_arrivals += k - nb
            vid = np.concatenate(
                [vid, np.arange(self._next_vid, self._next_vid + k,
                                dtype=np.int64)])
            self._next_vid += k
            x = np.concatenate([x, x_new])
            v = np.concatenate([v, v_new])
            phi = np.concatenate([phi, caps[0]])
            fm = np.concatenate([fm, caps[1]])
            fc = np.concatenate([fc, caps[2]])
            vc = np.concatenate([vc, caps[3]])
            shadow = np.concatenate([shadow, sh_new])
            part = np.concatenate([part, p_new])
            self.stats.arrivals += k

        self.state = WorldState(vid=vid, x=x, v=v, phi_max=phi, f_mem=fm,
                                f_core=fc, v_core=vc, shadow_db=shadow,
                                partition=part)
        self.stats.time += float(dt)
        self.stats.steps += 1

    # ------------------------------------------------------------------
    def remove(self, vids: Sequence[int]) -> int:
        """Force-remove vehicles by id (fault-injected mid-round departures,
        fl/faults.py): they leave coverage immediately, releasing their data
        partitions exactly like a natural chord exit. Draws no RNG, so the
        subsequent `step` consumes the stream identically whether or not a
        removal happened. Returns the number actually removed (ids already
        gone are ignored)."""
        if len(vids) == 0:
            return 0
        st = self.state
        drop = np.isin(st.vid, np.asarray(list(vids), np.int64))
        gone = np.flatnonzero(drop)
        if gone.size == 0:
            return 0
        released = st.partition[gone]
        self._free.extend(int(p) for p in released if p >= 0)
        self.stats.departures += int(gone.size)
        keep = ~drop
        self.state = WorldState(
            vid=st.vid[keep], x=st.x[keep], v=st.v[keep],
            phi_max=st.phi_max[keep], f_mem=st.f_mem[keep],
            f_core=st.f_core[keep], v_core=st.v_core[keep],
            shadow_db=st.shadow_db[keep], partition=st.partition[keep])
        return int(gone.size)

    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        """Live vehicles on the road (bound + unbound)."""
        return self.state.n

    @property
    def n_bound(self) -> int:
        """Vehicles holding a data partition (the potential FL clients)."""
        return int(np.sum(self.state.partition >= 0))

    def observe(self, obs) -> None:
        """Push the world's cumulative stats — tracked since construction
        but previously never surfaced — into a `repro.obs` registry. Reads
        only; never touches the rng or the arrays."""
        obs.gauge("world/population", self.n)
        obs.gauge("world/bound", self.n_bound)
        obs.gauge("world/time_s", self.stats.time)
        obs.gauge("world/arrivals", self.stats.arrivals)
        obs.gauge("world/departures", self.stats.departures)
        obs.gauge("world/blocked_arrivals", self.stats.blocked_arrivals)

    # ------------------------------------------------------------------
    def fleet(self, hists: Sequence[np.ndarray], sizes: Sequence[int]
              ) -> Tuple[List[Vehicle], np.ndarray]:
        """View the data-bound vehicles as `Vehicle`s for selection/planning.

        Returns (fleet, parts) where parts[j] is the data-partition index of
        fleet[j] — the runner uses it to fetch the vehicle's local dataset.
        """
        st = self.state
        bound = np.flatnonzero(st.partition >= 0)
        parts = st.partition[bound]
        # partitions are static for the runner's lifetime: normalize the
        # histograms and take their EMDs (core/emd.py, eq. 3) once per
        # distinct hists object (identity-keyed, so swapped-in data of the
        # same length cannot serve stale EMDs)
        if self._hists_src is not hists:
            self._hists_src = hists
            self._hists64 = [np.asarray(h, np.float64) for h in hists]
            self._emds = (emd_many(np.stack(self._hists64))
                          if self._hists64 else np.zeros(0))
        fleet: List[Vehicle] = []
        for i, p in zip(bound, parts):
            fleet.append(Vehicle(
                vid=int(st.vid[i]),
                x=float(st.x[i]),
                v=float(st.v[i]),
                phi_max=float(st.phi_max[i]),
                f_mem=float(st.f_mem[i]),
                f_core=float(st.f_core[i]),
                v_core=float(st.v_core[i]),
                data_size=int(sizes[p]),
                hist=self._hists64[p],
                emd=float(self._emds[p]),
                gain_db=float(st.shadow_db[i]),
            ))
        return fleet, parts
