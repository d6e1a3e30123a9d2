"""End-to-end GenFV training on the PyTorch port (the twin of
examples/genfv_cifar.py, paper Sec. VI): federated training of the
ResNet-18-style CNN on the CIFAR10-like procedural dataset with Dirichlet
non-IID partitions, comparing GenFV against FL-only and FedAvg.

  python examples/torch_genfv_cifar.py [--rounds 12] [--alpha 0.1]
                                       [--device cuda|cpu] [--quick]

12 rounds x 16 vehicles x 4 local steps = ~768 SGD steps through the
federated pipeline. The device defaults to "cuda" and the run fails
without one; pass `--device cpu` to run on the CPU. `--quick` runs one
round on 400 training and 64 test images.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs.base import GenFVConfig  # noqa: E402
from repro_torch.exp import ExperimentSpec, Sweep  # noqa: E402
from repro_torch.fl import RunConfig  # noqa: E402
from repro_torch.models.api import resolve_device  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--dataset", default="cifar10")
    ap.add_argument("--schemes", default="genfv,fl_only,fedavg")
    ap.add_argument("--scenario", default="highway_free_flow",
                    help="repro_torch.sim traffic scenario, or 'legacy' for the "
                         "memoryless per-round fleet sampler")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="one round, 400 training and 64 test images")
    args = ap.parse_args()
    device = resolve_device(args.device)
    rounds, train_size, test_size = args.rounds, 2000, 192
    if args.quick:
        rounds, train_size, test_size = 1, 400, 64

    # one declarative grid over the scheme axis; Sweep shares the dataset
    # build across schemes and plans all their rounds in batched dispatches
    spec = ExperimentSpec(
        name="genfv_cifar",
        strategies=tuple(args.schemes.split(",")),
        alphas=(args.alpha,),
        base=RunConfig(dataset=args.dataset, rounds=rounds,
                       train_size=train_size, test_size=test_size, width_mult=0.125,
                       seed=3, model_bits=11.2e6 * 32,
                       scenario=args.scenario))
    fl_cfg = GenFVConfig(batch_size=16, local_steps=4, num_vehicles=16)
    result = Sweep(spec, fl_cfg=fl_cfg, verbose=True, device=device).run()

    print("\n=== summary (mean of last 3 rounds) ===")
    for scheme in spec.strategies:
        acc = result.curve("accuracy", strategy=scheme)
        print(f"  {scheme:10s} acc={np.mean(acc[-3:]):.3f}  "
              f"curve={[round(a, 3) for a in acc.tolist()]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
