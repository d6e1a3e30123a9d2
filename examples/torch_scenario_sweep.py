"""Scenario sweep on the PyTorch port: the same GenFV pipeline under
different traffic worlds (the twin of examples/scenario_sweep.py).

  python examples/torch_scenario_sweep.py [--rounds N] [--scenarios a,b]
                                          [--device cuda|cpu] [--save]

One `repro_torch.exp` experiment: the scenario axis of an `ExperimentSpec`
enumerates the registered traffic presets (repro_torch/sim/scenarios.py),
and `Sweep` runs every cell on one device, sharing one dataset build and
FleetEngine. Only cells whose config after the scenario overlay agrees
(a strategy axis, say) share a batched SUBP2-4 planner dispatch; each
scenario overlays its own config, so here every cell plans alone. The
summary table shows how traffic shapes federated learning: rush-hour jams
keep vehicles in coverage for many rounds (stable fleets, few dropouts),
free-flow highways churn the fleet, sparse cells starve selection.
The device defaults to "cuda" and the run fails without one; pass
`--device cpu` to run on the CPU.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import GenFVConfig  # noqa: E402
from repro_torch.exp import ExperimentSpec, Sweep  # noqa: E402
from repro_torch.fl import RunConfig  # noqa: E402
from repro_torch.sim import scenario_names  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--scenarios", default="",
                    help="comma-separated subset (default: all registered)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save", action="store_true",
                    help="write the artifacts/torch_scenario_sweep.sweep.json "
                         "artifact")
    args = ap.parse_args()
    names = tuple([s for s in args.scenarios.split(",") if s]
                  or scenario_names())

    spec = ExperimentSpec(
        name="torch_scenario_sweep",
        scenarios=names,
        base=RunConfig(rounds=args.rounds, train_size=600, test_size=64,
                       width_mult=0.125))
    result = Sweep(spec, fl_cfg=GenFVConfig(batch_size=16, local_steps=2,
                                            num_vehicles=10),
                   device=args.device).run()
    if args.save:
        print(f"artifact: {result.save()}")

    print(f"{len(names)} scenarios on {args.device}, "
          f"{result.meta['planner_dispatches']} batched planner dispatches "
          f"(largest batch {result.meta['planner_largest_batch']}), "
          f"{result.meta['dataset_builds']} dataset builds for "
          f"{spec.n_cells} cells")
    print(f"\n{'scenario':<20} {'sel/round':>9} {'dropped':>8} "
          f"{'t_bar':>7} {'emd_bar':>8} {'final acc':>10}")
    for name in names:
        sub = result.select(scenario=name)
        print(f"{name:<20} "
              f"{float(sub.curve('selected', scenario=name).mean()):>9.1f} "
              f"{int(sub.curve('dropped', scenario=name).sum()):>8d} "
              f"{float(sub.curve('t_bar', scenario=name).mean()):>7.2f} "
              f"{float(sub.curve('emd_bar', scenario=name).mean()):>8.2f} "
              f"{float(sub.final('accuracy')[0]):>10.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
