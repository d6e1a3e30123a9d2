"""The output check: the program's rounds against the reference's.

A sample of the window's rounds, drawn from the seed with the round that
selected the most vehicles in it, is redone by the reference from the state
each round started in (see `reference/round.py`); the plan and the
evaluation are checked in every round. A cell's limits file names the
numbers it compares; each is the worst over the rounds it covers, but
eval_gap, which is their sum, loss_gap, their median, and aug_loss_gap,
their least:

* plan_gap: the plan's largest relative gap in l, phi, t_bar and b_gen, or
  1 where the selected set differs;
* loss_gap: the round's loss (the vehicles' mean local-SGD loss) against
  the reference's, relative; the median over the sampled rounds, since a
  round from fresh weights or of three vehicles amplifies rounding along
  its later steps (PERF.md);
* agg_gap: the global parameters after eq. 4 against the reference's eq. 4
  over its own vehicle models and the program's omega_a, as the norm of the
  difference over the norm of the reference's change in the round;
* aug_gap: omega_a against the reference's omega_a, as the gap between
  the norms of the two changes from the round's start over the norm of the
  reference's change (omega_a's 16 steps on a pool of a few dozen images
  amplify rounding, so neither the difference nor a single leaf's norm is
  a steady number: PERF.md);
* gen_gap: the images each round added to the program's pool against the
  generator reference's images for the same labels, round key and weights,
  as the largest relative L2 distance over the round's images (1 where
  their counts differ); over every round up to the last sampled one, the
  rounds whose pool the check rebuilds;
* aug_loss_gap: the mean loss of omega_a's 16 steps, as the program's
  `train_augmented` returns it, against the reference's, relative; the
  least over the sampled rounds: a step that trains on the wrong images
  moves it in every round, where the norms of the whole change cannot
  tell, while rounding grows into gaps as large only in a few rounds
  (from fresh weights, or where omega_a's steps diverge: PERF.md);
* eval_gap: how far the program's count of test images classified right
  lies outside the reference's, from a forward pass on the same parameters,
  summed over the rounds: the images whose true class leads or trails the
  best other class by more than 1e-4 x (1 + the largest |logit|) count as
  they fall, the others (a near tie, whose argmax float32 rounding may turn
  either way) may fall either way.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import model as M
from port_bench.reference.round import Partitions, eq4, plan_only, run_round, to_device
from port_bench.reference.solvers import label_schedule
from port_bench.spec import load_generator

VEHICLE_KEYS = ("x", "v", "phi_max", "f_mem", "f_core", "v_core", "gain_db")


def sample_rounds(rounds: list, seed: int, n: int) -> list:
    """Indices of the rounds to check: the first that selected the most
    vehicles, and n - 1 more drawn from the seed."""
    if len(rounds) <= n:
        return list(range(len(rounds)))
    top = max(range(len(rounds)), key=lambda i: (rounds[i]["log"].selected, -i))
    rest = [i for i in range(len(rounds)) if i != top]
    more = np.random.default_rng([seed % 2 ** 63, 2]).choice(rest, n - 1, replace=False)
    return sorted([top] + [int(i) for i in more])


def round_state(r: dict) -> dict:
    """What the reference takes of a program round: the world's fleet, b_prev
    and the random stream where the round starts drawing."""
    fleet = [{k: float(getattr(v, k)) for k in VEHICLE_KEYS} for v in r["pending"].fleet]
    return {"fleet": fleet, "parts": np.asarray(r["pending"].parts), "b_prev": r["b_prev"],
            "rng_select": r.get("rng_select"),
            "rng_train": r.get("rng_generate") or r.get("rng_local_sgd")}


def program_output(r: dict, n_test: int) -> dict:
    """What the program's round i produced: its plan, loss, global
    parameters, omega_a and count of test images classified right."""
    plan = r["plan"]
    aug_loss = r.get("aug_loss")
    return {"plan": {"selected": list(plan.selected), "l": np.asarray(plan.l, np.float64),
                     "phi": np.asarray(plan.phi, np.float64), "t_bar": float(plan.t_bar),
                     "b_gen": int(plan.b_gen)},
            "loss": float(r["log"].loss), "p1": r.get("p1"), "aug": r.get("aug"),
            "aug_loss": None if aug_loss is None else float(aug_loss),
            "correct": int(round(r["log"].accuracy * n_test))}


# -- the numbers ----------------------------------------------------------------
def plan_gap(a: dict, b: dict) -> float:
    if list(a["selected"]) != list(b["selected"]):
        return 1.0
    if not b["selected"]:
        return 0.0

    def rel(x, y):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        return float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-300)))
    return max(rel(a["l"], b["l"]), rel(a["phi"], b["phi"]), rel(a["t_bar"], b["t_bar"]),
               abs(a["b_gen"] - b["b_gen"]) / max(abs(b["b_gen"]), 1))


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300


@torch.no_grad()
def _norms(a, b, p0):
    la, lb, l0 = M.leaves(a), M.leaves(b), M.leaves(p0)
    diff = [float(torch.linalg.vector_norm(x.double() - y.double())) for x, y in zip(la, lb)]
    move_a = [float(torch.linalg.vector_norm(x.double() - z.double())) for x, z in zip(la, l0)]
    move_b = [float(torch.linalg.vector_norm(y.double() - z.double())) for y, z in zip(lb, l0)]
    return np.array(diff), np.array(move_a), np.array(move_b)


def whole_gap(a, b, p0) -> float:
    """|a - b| / |b - p0| over the whole parameter vector."""
    diff, _, move = _norms(a, b, p0)
    return _finite(float(np.sqrt(np.sum(diff ** 2)) / max(np.sqrt(np.sum(move ** 2)), 1e-300)))


def whole_norm_gap(a, b, p0) -> float:
    """||a - p0| - |b - p0|| / |b - p0| over the whole parameter vector."""
    _, move_a, move = _norms(a, b, p0)
    na, nb = np.sqrt(np.sum(move_a ** 2)), np.sqrt(np.sum(move ** 2))
    return _finite(float(abs(na - nb) / max(nb, 1e-300)))


def gen_gap(a, b: np.ndarray) -> float:
    """max_j |a_j - b_j| / |b_j| over the images of a round, the program's
    `a` against the reference's `b`; 1 where their counts differ."""
    a = np.empty((0,) + b.shape[1:], np.float32) if a is None else np.asarray(a)
    if a.shape != b.shape:
        return 1.0
    if not len(b):
        return 0.0
    a, b = a.reshape(len(b), -1).astype(np.float64), b.reshape(len(b), -1).astype(np.float64)
    gaps = np.linalg.norm(a - b, axis=1) / np.maximum(np.linalg.norm(b, axis=1), 1e-30)
    return _finite(float(np.max(gaps)))


def count_gap(n: int, band: tuple) -> float:
    """How far the count n lies outside [sure, sure + ties]."""
    lo, hi = band[:2]
    return float(max(lo - n, n - hi, 0))


def rel_gap(a, b: float) -> float:
    """|a - b| / |b|; a missing `a` is infinitely far."""
    if a is None:
        return 1e300
    return _finite(abs(a - b) / max(abs(b), 1e-30))


def numbers(prog: dict, ref: dict, p0, ref_band: tuple) -> dict:
    """The numbers of one round, the program's output `prog` against the
    reference's round `ref`; `ref_band` is the reference's count of the
    test images classified right, (sure, sure + near ties)."""
    out = {"plan_gap": plan_gap(prog["plan"], ref["plan"]),
           "loss_gap": rel_gap(prog["loss"], ref["loss"]),
           "eval_gap": count_gap(prog["correct"], ref_band)}
    aug = prog["aug"] if ref["aug"] is not None else None
    if ref["aug"] is not None and aug is None:
        aug = p0
    given = eq4(p0, ref["models"], ref["rho"], ref["kappa"], aug)
    out["agg_gap"] = whole_gap(prog["p1"], given, p0)
    if ref["aug"] is not None:
        out["aug_gap"] = whole_norm_gap(aug, ref["aug"], p0)
    if ref.get("aug_loss") is not None:
        out["aug_loss_gap"] = rel_gap(prog.get("aug_loss"), ref["aug_loss"])
    return out


class Reference:
    """The reference's view of one run: the clients' partition of the
    benchmark's data, the test set on the device, the generator reference
    the configuration names with its weights drawn from the run's seed, and
    the generated pool rebuilt round by round from the program's plans and
    random stream states."""

    def __init__(self, cell: dict, train, test, world_seed: int, device, seed: int):
        c = cell["c"]
        self.cell, self.device = cell, device
        self.data = Partitions.build(train[0], train[1], cell["classes"],
                                     c["num_vehicles"], c["dirichlet_alpha"], world_seed)
        self.test_x = to_device(test[0], device)
        self.test_y = torch.from_numpy(test[1].astype(np.int64)).to(device)
        self.block = cell["generator"]
        self.gen = load_generator(self.block["reference"], cell["dir"])
        self.gen_params = self.gen.make_params(self.block, seed, device)
        self._images = {}

    def generator(self, t: int, prec=M.FP32, fault=None):
        """The generate(labels, rng) of round t, for `run_round`."""
        def generate(labels, rng):
            return self.gen.generate(self.block, self.gen_params, labels, rng,
                                     self.cell["world_seed"], t, self.device,
                                     prec=prec, fault=fault)
        return generate

    def images(self, rounds: list, i: int, prec=M.FP32, fault=None):
        """(images, labels) the reference generates for the program's plan of
        round i, from the stream state where the round's generation starts."""
        r = rounds[i]
        key = (i, prec.tf32, fault)
        if key not in self._images:
            labels = np.repeat(np.arange(self.cell["classes"]),
                               label_schedule(int(r["plan"].b_gen), self.cell["classes"]))
            rng = np.random.default_rng()
            rng.bit_generator.state = r["rng_generate"]
            self._images[key] = (self.generator(r["t"], prec, fault)(labels, rng),
                                 labels.astype(np.int32))
        return self._images[key]

    def pool_before(self, rounds: list, i: int, prec=M.FP32):
        """The generated pool at the start of round i, its images generated
        in `prec`."""
        px = py = None
        if self.cell["strategy"] != "genfv":
            return px, py
        for j in range(i):
            imgs, labels = self.images(rounds, j, prec)
            if not len(labels):
                continue
            px = imgs if px is None else np.concatenate([px, imgs])
            py = labels if py is None else np.concatenate([py, labels])
        n = 0 if py is None else len(py)
        if n != rounds[i]["pool_n"]:
            raise AssertionError(f"round {i}: the reference's pool holds {n} images, "
                                 f"the program's {rounds[i]['pool_n']}")
        return px, py

    def round(self, rounds: list, i: int, prec=M.FP32, ft=np.float64, half_batch=()):
        """The reference's round i (`run_round`'s dict)."""
        r = rounds[i]
        return run_round(self.cell, round_state(r), self.data,
                         self.pool_before(rounds, i, prec), r["p0"], prec, ft,
                         half_batch=half_batch,
                         generate=self.generator(r["t"], prec))

    def plan(self, rounds: list, i: int) -> dict:
        """The reference's plan of round i alone."""
        return plan_only(self.cell, round_state(rounds[i]), self.data)

    def correct(self, params, prec=M.FP32) -> tuple:
        """(images surely right, surely right + near ties, argmax right) on
        the test set."""
        with prec.active(self.device):
            return M.count_correct(params, self.test_x, self.test_y, prec=prec)


def check(ref: Reference, rounds: list, picked: list) -> dict:
    """The numbers of each of the program's rounds `picked`, the plan_gap
    and eval_gap of every other round, and where the strategy generates,
    the gen_gap of every round up to the last picked."""
    out = {}
    for i, r in enumerate(rounds):
        prog = program_output(r, len(ref.test_y))
        band = ref.correct(r["p1"])
        if i in picked:
            out[i] = numbers(prog, ref.round(rounds, i), r["p0"], band)
        else:
            out[i] = {"plan_gap": plan_gap(prog["plan"], ref.plan(rounds, i)),
                      "eval_gap": count_gap(prog["correct"], band)}
        if ref.cell["strategy"] == "genfv" and i <= max(picked, default=-1):
            out[i]["gen_gap"] = gen_gap(r.get("gen"), ref.images(rounds, i)[0])
    return out


#: how a number is judged over the rounds, where not by its largest value
OVER_ROUNDS = {"eval_gap": sum, "loss_gap": np.median, "aug_loss_gap": min}


def worst(per_round: dict, names) -> dict:
    """The judged value of each number over the rounds: the sum of
    eval_gap, the median of loss_gap, the least of aug_loss_gap, the
    largest of the others."""
    out = {}
    for k in names:
        vals = [x[k] for x in per_round.values() if k in x]
        out[k] = float(OVER_ROUNDS.get(k, max)(vals))
    return out


def judge(numbers: dict, limits: dict) -> dict:
    """Each number the limits name beside its limit; a number passes where
    it is at most its limit."""
    return {k: {"value": float(numbers[k]), "limit": float(lim),
                "ok": bool(numbers[k] <= lim)} for k, lim in limits.items()}
