"""Seeded fault injection for GenFV rounds, the counterpart of the JAX
package's `fl/faults.py` (host numpy, copied so that it imports without
jax; the same spec and round give the same draws bit for bit).

Failure modes, each drawn per selected vehicle per round:

  * compute stragglers  — per-vehicle slowdown multipliers on the eq.-6
    training delay t_cp (thermal throttling, contended GPU);
  * upload outages      — a deep shadow fade (dB) applied on top of the
    vehicle's slow-fading gain, re-pricing eq.-10 upload time at the
    planned (l, phi) allocation;
  * forced departures   — extra mid-round exits beyond the world's natural
    coverage churn (lane change, tunnel, ignition-off);
  * poisoned updates    — NaN client deltas (malfunctioning or adversarial
    OBU), caught by the finiteness guard of eq. 4
    (core/emd.py::aggregate_stacked_guarded).

Determinism contract: every round draws from a fresh
`SeedSequence(spec.seed, round)` stream in a FIXED order (slowdown, outage,
departure, poison — k draws each), so faults are a pure function of
(spec, round, fleet size). Identical across vectorized/sequential paths,
across planner backends, and across checkpoint resume — the injector holds
no mutable state.

Recovery machinery lives here too: `StaleBuffer` keeps late-but-finite
updates and releases them to the next FL round with staleness-discounted
weights  rho_eff = rho * gamma^age  (gamma = spec.staleness_discount,
age = merge_round - trained_round), dropping entries older than
spec.max_staleness.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import GenFVConfig
from repro_torch.core import channel, mobility

__all__ = [
    "FaultSpec", "RoundFaults", "FaultInjector", "StaleEntry", "StaleBuffer",
    "register_fault", "get_fault", "fault_names", "realized_arrivals",
    "realized_times",
]


@dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault schedule. Frozen so it can ride inside
    RunConfig-adjacent payloads and checkpoint metadata; all probabilities
    are per-selected-vehicle per-round."""
    seed: int = 0
    start_round: int = 0            # first faulty round (inclusive)
    end_round: int | None = None    # first clean round again (None = never)
    straggler_prob: float = 0.0
    straggler_slowdown: float = 3.0  # multiplier on t_cp when straggling
    outage_prob: float = 0.0
    outage_fade_db: float = 20.0     # extra shadow fade during an outage
    departure_prob: float = 0.0
    poison_prob: float = 0.0
    # -- recovery policy ---------------------------------------------------
    deadline_slack: float = 0.25     # deadline = t_bar * (1 + slack)
    staleness_discount: float = 0.5  # gamma in rho_eff = rho * gamma^age
    max_staleness: int = 2           # rounds a buffered update stays usable

    def __post_init__(self):
        for name in ("straggler_prob", "outage_prob", "departure_prob",
                     "poison_prob"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}={p} outside [0, 1]")
        if self.straggler_slowdown < 1.0:
            raise ValueError("straggler_slowdown must be >= 1 (it multiplies "
                             "the planned training delay)")
        if self.deadline_slack < 0.0:
            raise ValueError("deadline_slack must be >= 0")
        if not 0.0 < self.staleness_discount <= 1.0:
            raise ValueError("staleness_discount must be in (0, 1]")
        if self.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")

    def active(self, t: int) -> bool:
        return t >= self.start_round and (self.end_round is None
                                          or t < self.end_round)

    def to_payload(self) -> dict:
        import dataclasses
        return dataclasses.asdict(self)

    @classmethod
    def from_payload(cls, payload: dict) -> "FaultSpec":
        return cls(**payload)


# ---------------------------------------------------------------------------
# Registry — named schedules referencable from RunConfig.faults (a plain
# string, so frozen experiment cells stay hashable/serializable).
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, FaultSpec] = {}


def register_fault(name: str, spec: FaultSpec) -> FaultSpec:
    if name in _REGISTRY:
        raise ValueError(f"fault schedule {name!r} already registered")
    _REGISTRY[name] = spec
    return spec


def get_fault(name: str) -> FaultSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown fault schedule {name!r}; registered: "
                       f"{', '.join(sorted(_REGISTRY))}")
    return _REGISTRY[name]


def fault_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# The JAX package's headline schedules (its bench_faults.py): platoon mass-dropout
# stresses SUBP1's admission when a convoy exits together; rush-hour deep
# fade stresses the deadline/staleness recovery path when uploads suddenly
# cost 20 dB more at the planned (l, phi).
register_fault("platoon_mass_dropout",
               FaultSpec(seed=101, start_round=2, departure_prob=0.45,
                         straggler_prob=0.15, straggler_slowdown=2.0))
register_fault("rush_hour_deep_fade",
               FaultSpec(seed=202, start_round=2, outage_prob=0.5,
                         outage_fade_db=20.0, deadline_slack=0.25))
register_fault("compute_stragglers",
               FaultSpec(seed=303, straggler_prob=0.4,
                         straggler_slowdown=4.0, deadline_slack=0.15))
register_fault("poison_minority",
               FaultSpec(seed=404, poison_prob=0.25))
register_fault("mixed_stress",
               FaultSpec(seed=505, start_round=1, straggler_prob=0.2,
                         straggler_slowdown=3.0, outage_prob=0.2,
                         departure_prob=0.1, poison_prob=0.1))


# ---------------------------------------------------------------------------
# Per-round realizations.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RoundFaults:
    """One round's realized faults over the K selected vehicles."""
    slowdown: np.ndarray   # [K] float, >= 1 (1 = nominal)
    outage: np.ndarray     # [K] bool — deep fade on the upload
    departed: np.ndarray   # [K] bool — forced mid-round exit
    poisoned: np.ndarray   # [K] bool — NaN update

    @property
    def any(self) -> bool:
        return bool((self.slowdown > 1.0).any() or self.outage.any()
                    or self.departed.any() or self.poisoned.any())


def _benign(k: int) -> RoundFaults:
    return RoundFaults(np.ones(k), np.zeros(k, bool), np.zeros(k, bool),
                       np.zeros(k, bool))


class FaultInjector:
    """Stateless draw engine: `draw(t, k)` is a pure function of
    (spec.seed, t, k), so resume-from-checkpoint replays faults exactly
    without persisting any injector state."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec

    def draw(self, t: int, k: int) -> RoundFaults:
        if k == 0 or not self.spec.active(t):
            return _benign(k)
        s = self.spec
        # round-keyed stream; FIXED draw order — never reorder these, the
        # determinism tests pin realizations
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=(s.seed, t)))
        slow = np.where(rng.random(k) < s.straggler_prob,
                        s.straggler_slowdown, 1.0)
        outage = rng.random(k) < s.outage_prob
        departed = rng.random(k) < s.departure_prob
        poisoned = rng.random(k) < s.poison_prob
        # a departed vehicle's update never arrives; poisoning it is moot
        poisoned &= ~departed
        return RoundFaults(slow, outage, departed, poisoned)


def _faded_upload_times(cfg: GenFVConfig, fleet: Sequence, plan,
                        model_bits: float, mask: np.ndarray,
                        fade_db: float) -> np.ndarray:
    """eq.-10 upload times for the `mask`ed selected positions, re-priced at
    the PLANNED (l, phi) under an extra `fade_db` shadow fade. Shared by the
    synchronous `realized_times` (outage = slow-but-successful upload) and
    the streaming `realized_arrivals` (outage = failed attempt + retry)."""
    idx = [plan.selected[i] for i in np.nonzero(mask)[0]]
    xs = np.array([fleet[j].x for j in idx], np.float64)
    gains = np.array([fleet[j].gain_db for j in idx], np.float64)
    dists = mobility.rsu_distances(cfg, xs)
    return channel.upload_times(
        cfg, model_bits, np.asarray(plan.l, np.float64)[mask],
        np.asarray(plan.phi, np.float64)[mask], dists,
        gain_db=gains - fade_db)


def realized_times(cfg: GenFVConfig, fleet: Sequence, plan,
                   model_bits: float, rf: RoundFaults,
                   fade_db: float) -> np.ndarray:
    """Per-selected realized round time under faults: straggler-inflated
    training plus the (possibly deep-faded) eq.-10 upload priced at the
    PLANNED allocation (l, phi) — the RSU committed the schedule before the
    fault materialized, which is exactly why a deadline is needed.
    """
    t_cp = rf.slowdown * np.asarray(plan.t_cp, np.float64)
    t_mu = np.asarray(plan.t_mu, np.float64).copy()
    if rf.outage.any():
        t_mu[rf.outage] = _faded_upload_times(cfg, fleet, plan, model_bits,
                                              rf.outage, fade_db)
    return t_cp + t_mu


#: entropy tag keying the per-attempt retry stream ("RTRY"), spawned per
#: round alongside — but distinct from — the draw() stream.
_RETRY_KEY = 0x52545259


def realized_arrivals(cfg: GenFVConfig, fleet: Sequence, plan,
                      model_bits: float, rf: RoundFaults, spec: FaultSpec,
                      t: int, *, retry_budget: int, backoff_s: float,
                      backoff_cap_s: float
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Streaming-mode realization (fl/stream.py): per-selected ABSOLUTE
    upload-completion offsets from the round start, with retry/backoff for
    outaged uploads.

    Unlike the synchronous `realized_times` — where an outage is a
    slow-but-successful upload the deadline judges — a streaming outage is a
    FAILED attempt: the transfer dies after the deep-faded airtime, the
    vehicle backs off min(backoff_s * 2^a, backoff_cap_s), and retries.
    Each retry draws channel recovery from a round-keyed per-attempt stream
    (`SeedSequence((spec.seed, t, _RETRY_KEY))`, one [K, budget] uniform
    block in fixed order — pure function of (spec, round, K), resumable):
    a recovered attempt is re-priced through the same eq.-10 pricing at the
    vehicle's refreshed (nominal) channel gain; a still-faded one burns the
    faded airtime again. A vehicle whose retry budget exhausts never
    arrives.

    Returns ``(times, retries, exhausted)`` over the K selected positions:
    arrival offsets (np.inf = the update never arrives), retry attempts
    consumed, and the permanently-failed mask. A departed vehicle's retry is
    NEVER scheduled — its update can never arrive (times=inf, retries=0).
    """
    k = len(plan.selected)
    t_cp = rf.slowdown * np.asarray(plan.t_cp, np.float64)
    t_mu = np.asarray(plan.t_mu, np.float64)
    times = t_cp + t_mu
    retries = np.zeros(k, np.int64)
    exhausted = np.zeros(k, bool)
    retrying = rf.outage & ~rf.departed   # departed: no retry, ever
    if retrying.any():
        t_fade = np.zeros(k, np.float64)
        t_fade[retrying] = _faded_upload_times(
            cfg, fleet, plan, model_bits, retrying, spec.outage_fade_db)
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=(spec.seed, t, _RETRY_KEY)))
        # one fixed-shape block, drawn whether or not every attempt is used
        u = rng.random((k, retry_budget)) if retry_budget else \
            np.zeros((k, 0))
        for pos in np.nonzero(retrying)[0]:
            acc = t_cp[pos] + t_fade[pos]        # attempt 0 dies in the fade
            recovered = False
            for a in range(retry_budget):
                acc += min(backoff_s * (2.0 ** a), backoff_cap_s)
                retries[pos] += 1
                if u[pos, a] >= spec.outage_prob:
                    acc += t_mu[pos]             # refreshed gain: nominal
                    recovered = True
                    break
                acc += t_fade[pos]               # still deep-faded: burn it
            if recovered:
                times[pos] = acc
            else:
                times[pos] = np.inf
                exhausted[pos] = True
    return np.where(rf.departed, np.inf, times), retries, exhausted


# ---------------------------------------------------------------------------
# Staleness buffer.
# ---------------------------------------------------------------------------
@dataclass
class StaleEntry:
    params: object          # the late client's trained model (tree)
    size: int               # |D_n|
    emd: float              # EMD_n
    trained_round: int      # round whose global it descended from
    vid: int                # vehicle id (diagnostics)


@dataclass
class StaleBuffer:
    """Late-but-finite updates waiting to be merged. FIFO per round; ages
    are measured in completed rounds."""
    entries: List[StaleEntry] = field(default_factory=list)

    def push(self, entry: StaleEntry) -> None:
        self.entries.append(entry)

    def __len__(self) -> int:
        return len(self.entries)

    def pop_mergeable(self, t: int, max_staleness: int
                      ) -> Tuple[List[StaleEntry], List[int], int]:
        """Drain the buffer for the merge at round `t`: returns
        (mergeable entries, ages, dropped). Entries older than
        max_staleness are dropped — too stale to help (arXiv:2401.09656's
        bounded-staleness regime) — and COUNTED: the round loop feeds the
        drop count into RoundLog's fault ledger (`stale_dropped`) and the
        `faults/stale_dropped` obs counter instead of discarding silently.
        An entry exactly at ``age == max_staleness`` still merges (the
        bound is inclusive)."""
        merge, ages = [], []
        dropped = 0
        for e in self.entries:
            age = t - e.trained_round
            if age <= max_staleness:
                merge.append(e)
                ages.append(age)
            else:
                dropped += 1
        self.entries = []
        return merge, ages, dropped
