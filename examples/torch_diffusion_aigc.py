"""AIGC dataplane demo on the PyTorch port (the twin of
examples/diffusion_aigc.py, paper Sec. III-B): the diffusion service
behind ``RunConfig(generator="ddpm")`` — pretrained class-conditional DDPM,
one bucketed sampling pass per round, measured per-image latency priced
into eq. 48's schedule, and ``sampler_steps`` as a sweep axis.

  python examples/torch_diffusion_aigc.py [--rounds 2] [--device cuda|cpu]
                                          [--quick]

The first run pretrains the reference-pool generator (cached under
--ckpt-dir afterwards) and calibrates t0 into
artifacts/torch_gen_calib.json; reruns restore both. The device defaults
to "cuda" and the run fails without one; pass `--device cpu` to run on
the CPU. `--quick` shrinks the generator (8 timesteps, base width 8, 2
pretraining steps on 64 reference images) and the sampler axis to (2, 4)
steps, one round.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs.base import GenFVConfig  # noqa: E402
from repro_torch.exp import ExperimentSpec, Sweep  # noqa: E402
from repro_torch.fl.rounds import RunConfig  # noqa: E402
from repro_torch.gen import (calibrated_service, gen_round_key, pretrain_ddpm,  # noqa: E402
                             runner_ddpm, sample_schedule)
from repro_torch.gen import service  # noqa: E402
from repro_torch.models.api import resolve_device  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="artifacts")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="a small generator and sampler, one round")
    args = ap.parse_args()
    device = resolve_device(args.device)
    steps_axis, demo_steps, rounds = (10, 50), 10, args.rounds
    if args.quick:
        # the runner's generator reads these module constants when it builds
        service.RUNNER_TIMESTEPS, service.RUNNER_BASE_WIDTH = 8, 8
        service.PRETRAIN_STEPS, service.PRETRAIN_REF = 2, 64
        steps_axis, demo_steps, rounds = (2, 4), 2, 1

    # 1. the RSU foundation model: pretrain (or restore) the generator the
    #    runner itself serves, on the same budget, checkpointed
    ddpm = runner_ddpm(num_classes=10)
    params, losses = pretrain_ddpm(
        ddpm, steps=service.PRETRAIN_STEPS, ref_size=service.PRETRAIN_REF,
        ckpt_path=os.path.join(args.ckpt_dir, "torch_ddpm_demo"), device=device)
    if losses:
        print(f"[pretrain] {len(losses)} steps, "
              f"final loss {losses[-1]:.4f}")
    else:
        print("[pretrain] restored from checkpoint")

    # 2. sample one round schedule directly: round-keyed stream, bucketed
    #    batched pass (the exact path the server takes)
    imgs = sample_schedule(params, ddpm, gen_round_key(seed=0, round_idx=0),
                           labels=np.arange(10) % 10, sampler_steps=demo_steps)
    print(f"[sample] {imgs.shape} in [-1,1]: min={imgs.min():.2f} "
          f"max={imgs.max():.2f}")

    # 3. measured per-image cost -> eq. 12-13 delay terms (cached in
    #    artifacts/torch_gen_calib.json; the runner does this implicitly)
    svc = calibrated_service(params, ddpm, sampler_steps=demo_steps)
    print(f"[calib] t0 = {svc.t_per_image * 1e3:.1f} ms/image "
          f"({svc.source}, steps={svc.steps})")

    # 4. the round loop end to end: generator="ddpm" swaps the oracle for
    #    this service, and sampler_steps is a first-class sweep axis — the
    #    SUBP4 quality/cost dial
    print("\n[genfv] sampler_steps sweep with the DDPM as the AIGC service")
    spec = ExperimentSpec(
        name="diffusion_aigc",
        sampler_steps=steps_axis,
        base=RunConfig(generator="ddpm", rounds=rounds, train_size=600,
                       test_size=64, width_mult=0.125))
    result = Sweep(spec,
                   fl_cfg=GenFVConfig(batch_size=16, local_steps=2,
                                      num_vehicles=8),
                   verbose=True, device=device).run()
    for i, cell in enumerate(result.cells):
        print(f"[genfv+ddpm] steps={cell['sampler_steps']:3d} "
              f"final accuracy {float(result.final('accuracy')[i]):.3f} "
              f"b_gen total {int(np.nansum(result.metrics['b_gen'][i]))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
