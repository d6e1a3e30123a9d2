"""Quickstart on the PyTorch port: the three layers of the framework (the
twin of examples/quickstart.py).

  python examples/torch_quickstart.py [--device cuda|cpu] [--quick]

1. paper math  — EMD weighting + the two-scale resource allocator
2. model zoo   — one backbone, prefill + greedy decode
3. experiments — a 2-cell repro_torch.exp grid, two GenFV rounds end-to-end

The device defaults to "cuda" and the run fails without one; pass
`--device cpu` to run on the CPU. `--quick` runs one round per cell.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import GenFVConfig  # noqa: E402
from repro_torch.core import mobility, plan_round  # noqa: E402
from repro_torch.core.emd import kappas  # noqa: E402
from repro_torch.exp import ExperimentSpec, Sweep  # noqa: E402
from repro_torch.fl import RunConfig  # noqa: E402
from repro_torch.models import api  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true", help="one round per cell")
    args = ap.parse_args()
    device = api.resolve_device(args.device)

    # ---- 1. the paper's control plane ---------------------------------------
    cfg = GenFVConfig()
    rng = np.random.default_rng(0)
    hists = rng.dirichlet(np.full(10, 0.3), size=30)       # vehicle label dists
    fleet = mobility.sample_fleet(rng, cfg, hists, rng.integers(500, 2000, 30))
    plan = plan_round(cfg, fleet, model_bits=11.2e6 * 32, batches=8, device=device)
    print(f"[two-scale] selected {len(plan.selected)}/{len(fleet)} vehicles, "
          f"t_bar={plan.t_bar:.2f}s, generate b={plan.b_gen} images")
    k1, k2 = kappas(float(np.mean([fleet[i].emd for i in plan.selected])))
    print(f"[eq.4] aggregation weights kappa1={k1:.3f} kappa2={k2:.3f}")

    # ---- 2. an architecture of the model zoo --------------------------------
    mcfg = get_config("qwen1.5-0.5b").reduced()
    params = api.init_params(torch.Generator(device=device).manual_seed(0), mcfg,
                             device=device)
    prompt = torch.randint(0, mcfg.vocab_size, (1, 16),
                           generator=torch.Generator().manual_seed(1))
    out = api.greedy_generate(mcfg, params, prompt, steps=8, device=device)
    print(f"[model] qwen1.5-0.5b (reduced) generated tokens: {out[0].tolist()}")

    # ---- 3. federated experiments -------------------------------------------
    spec = ExperimentSpec(
        strategies=("genfv", "fl_only"),      # a 2-cell grid
        base=RunConfig(rounds=1 if args.quick else 2, train_size=600, test_size=64,
                       width_mult=0.125))
    result = Sweep(spec, fl_cfg=GenFVConfig(batch_size=16, local_steps=2,
                                            num_vehicles=8),
                   verbose=True, device=device).run()
    for s in spec.strategies:
        print(f"[{s}] final accuracy "
              f"{float(result.curve('accuracy', strategy=s)[-1]):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
