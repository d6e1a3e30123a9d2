"""Batched serving demo on the PyTorch port (the twin of
examples/serve_demo.py): prefill a batch of prompts, then decode with the
ring-buffer KV cache. The default architecture has a sliding window, so
the ring buffer wraps.

  python examples/torch_serve_demo.py [--arch gemma2-9b] [--device cuda|cpu]
                                      [--quick]

The model is the architecture's `.reduced()` variant with random weights.
The device defaults to "cuda" and the run fails without one; pass
`--device cpu` to run on the CPU. `--quick` serves 2 prompts of 16
tokens and decodes 4.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="batch 2, prompts of 16 tokens, 4 decoded")
    args = ap.parse_args()
    if args.quick:
        args.batch, args.prompt_len, args.gen = 2, 16, 4
    device = api.resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    params = api.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                             device=device)
    B, P = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(1)).to(device)

    max_len = P + args.gen
    cache = api.init_cache(cfg, B, max_len, device=device)
    prefill = api.make_prefill_step(cfg)
    decode = api.make_decode_step(cfg)

    t0 = time.time()
    logits, cache = prefill(params, cache, {"tokens": prompts})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_prefill = time.time() - t0
    print(f"[serve] {args.arch} (reduced): prefill {B}x{P} tokens "
          f"in {t_prefill * 1e3:.1f} ms")

    outs = [torch.argmax(logits, -1)[:, None]]
    t0 = time.time()
    for t in range(P, P + args.gen - 1):
        pos = torch.full((B, 1), t, dtype=torch.int32, device=device)
        logits, cache = decode(params, cache, outs[-1], pos)
        outs.append(torch.argmax(logits, -1)[:, None])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = (time.time() - t0) / max(args.gen - 1, 1)
    print(f"[serve] decoded {args.gen} tokens/seq, {dt * 1e3:.1f} ms/token "
          f"(batch {B})")
    gen = torch.cat(outs, dim=1)
    for i in range(B):
        print(f"  seq{i}: {gen[i].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
