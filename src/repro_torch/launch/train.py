"""End-to-end training launcher for the LM backbones (the counterpart of the
JAX package's `launch/train.py`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 50 --batch 8 --seq 128 [--full] [--ckpt out.npz] \
      [--device cuda|cpu]

Trains the reduced variant by default (`--full` for the published
widths) on the Markov token stream of `data/synthetic.py`, with the
arch's own schedule (WSD for minicpm, cosine otherwise; warmup
max(steps // 20, 1)) and AdamW, through the plain torch route
(`impl="torch"`; the kernels have no gradient). Runs on the card unless
`--device cpu` is given. The exit code is 0 only when the loss fell.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_tree
from repro_torch.configs import get_config
from repro_torch.data.synthetic import batch_tokens, make_token_dataset
from repro_torch.models import api
from repro_torch.obs import log_line
from repro_torch.optim import get_schedule, make_optimizer
from repro_torch.tree import tree_leaves


def _log(text):
    """Every line lands (no rate limit), through the port's progress log."""
    log_line(None, "launch/train", text, force=True)


def _extras(cfg, batch: int, seed: int, device):
    """llava's patch embeddings and whisper's frames, from `seed`."""
    extras = {}
    if cfg.modality == "vision":
        extras["patch_embeds"] = np.random.default_rng(seed).normal(
            size=(batch, cfg.frontend_tokens, 1024))
    if cfg.modality == "audio":
        extras["frames"] = np.random.default_rng(seed).normal(
            size=(batch, cfg.encoder_seq, cfg.d_model))
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in extras.items()}


def train(arch: str, steps: int = 50, batch: int = 8, seq: int = 128,
          reduced: bool = True, lr: float = 3e-4, ckpt: str | None = None,
          seed: int = 0, log_every: int = 10, device="cuda"):
    """Returns (params, losses). Parameters are fp32, random from `seed`."""
    device = api.resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    sched = get_schedule(cfg.schedule, lr, steps, warmup=max(steps // 20, 1))
    opt = make_optimizer("adamw", sched)
    step_fn = api.make_train_step(cfg, opt)

    params = api.init_params(torch.Generator(device=device).manual_seed(seed), cfg,
                             device=device)
    state = opt.init(params)
    n = sum(p.numel() for p in tree_leaves(params))
    _log(f"[train] {arch} ({'reduced' if reduced else 'FULL'}): {n / 1e6:.2f}M params, "
         f"schedule={cfg.schedule}, device={device}")

    toks = make_token_dataset(cfg.vocab_size, batch * (seq + 1) * (steps + 2), seed=seed)
    extras = _extras(cfg, batch, seed, device)
    losses = []
    t0 = time.perf_counter()
    for s in range(steps):
        b = {k: torch.as_tensor(v, device=device)
             for k, v in batch_tokens(toks, batch, seq, s).items()}
        b["tokens"] = b["tokens"].long()
        b.update(extras)
        params, state, m = step_fn(params, state, b)
        losses.append(float(m["loss"]))
        if s % log_every == 0 or s == steps - 1:
            _log(f"  step {s:4d} loss {losses[-1]:.4f} ce {float(m['ce']):.4f} "
                 f"gnorm {float(m['grad_norm']):.2f} "
                 f"({(time.perf_counter() - t0) / (s + 1):.2f}s/step)")
    if ckpt:
        save_tree(ckpt, params, metadata={"arch": arch, "steps": steps,
                                          "final_loss": losses[-1]})
        _log(f"[train] checkpoint -> {ckpt}")
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="the published widths and depth")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, losses = train(args.arch, args.steps, args.batch, args.seq,
                      reduced=not args.full, lr=args.lr, ckpt=args.ckpt,
                      device=args.device)
    ok = losses[-1] < losses[0]
    _log(f"[train] loss {losses[0]:.3f} -> {losses[-1]:.3f} "
         f"({'improved' if ok else 'NOT improved'})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
