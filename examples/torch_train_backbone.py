"""Train any architecture end to end on the synthetic token stream with the
PyTorch port (the twin of examples/train_backbone.py): the launcher's
train step (`repro_torch.launch.train`), reduced config by default.

  python examples/torch_train_backbone.py [--arch olmoe-1b-7b] [--steps 30]
                                          [--full] [--device cuda|cpu] [--quick]

The device defaults to "cuda" and the run fails without one; pass
`--device cpu` to run on the CPU. `--quick` trains 6 steps of batch 4 at
sequence length 32. The exit code is 0 only when the loss fell.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import train  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="the published widths and depth")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true", help="6 steps, batch 4, sequence 32")
    args = ap.parse_args()
    if args.quick:
        args.steps, args.batch, args.seq = 6, 4, 32
    _, losses = train(args.arch, args.steps, args.batch, args.seq, reduced=not args.full,
                      lr=args.lr, log_every=max(args.steps // 5, 1), device=args.device)
    ok = losses[-1] < losses[0]
    print(f"[train] loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'improved' if ok else 'NOT improved'})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
