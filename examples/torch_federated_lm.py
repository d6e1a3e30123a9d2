"""GenFV on a language-model backbone with the PyTorch port (the twin of
examples/federated_lm.py; DESIGN.md §5: the technique consumes label or
token distributions and parameter trees, not images).

Vehicles hold non-IID token streams (each sees only a slice of the vocab,
the LM analogue of Dirichlet label skew); EMD is computed over token
unigram histograms; the RSU "generates" synthetic text from the full-vocab
reference stream (the token-level AIGC service) and trains the augmented
model; aggregation is eq. (4) verbatim (`repro_torch.core.emd`).

  python examples/torch_federated_lm.py [--arch qwen1.5-0.5b] [--device cuda|cpu]
                                        [--quick]

The model is the architecture's `.reduced()` variant with random weights.
The device defaults to "cuda" and the run fails without one; pass
`--device cpu` to run on the CPU. `--quick` runs 2 rounds of 2 local steps.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.emd import (aggregate, data_weights, emd as emd_fn,  # noqa: E402
                                  kappas, mean_emd)
from repro_torch.data.synthetic import make_token_dataset  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.transformer import loss_fn  # noqa: E402
from repro_torch.optim import constant_schedule, make_optimizer  # noqa: E402


def token_histogram(tokens, vocab, bins=16):
    h = np.bincount(np.asarray(tokens) % bins, minlength=bins).astype(float)
    return h / max(h.sum(), 1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true", help="2 rounds of 2 local steps")
    args = ap.parse_args()
    if args.quick:
        args.rounds, args.local_steps = 2, 2
    device = api.resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    B, S = 4, 48
    global_params = api.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                                    device=device)
    opt = make_optimizer("sgd", constant_schedule(0.3))
    step = api.make_train_step(cfg, opt, clip_norm=1.0)

    # non-IID client corpora: client i only sees tokens in its vocab slice
    rng = np.random.default_rng(0)
    full = make_token_dataset(cfg.vocab_size, 80_000, seed=1)
    slice_w = cfg.vocab_size // args.clients
    corpora, hists = [], []
    for i in range(args.clients):
        toks = i * slice_w + (full[i::args.clients] % slice_w)
        corpora.append(toks.astype(np.int32))
        hists.append(token_histogram(toks, cfg.vocab_size))
    emds = [emd_fn(h) for h in hists]
    print(f"[federated-lm] {args.arch} (reduced), {args.clients} clients, "
          f"token-EMDs: {[round(e, 2) for e in emds]}")

    def as_batch(chunk):
        return {"tokens": torch.as_tensor(chunk[:, :-1], dtype=torch.long, device=device),
                "targets": torch.as_tensor(chunk[:, 1:], device=device),
                "mask": torch.ones((B, S), dtype=torch.float32, device=device)}

    def local_train(params, corpus, steps):
        state = opt.init(params)
        loss = 0.0
        for _ in range(steps):
            start = int(rng.integers(0, len(corpus) - B * (S + 1)))
            chunk = corpus[start:start + B * (S + 1)].reshape(B, S + 1)
            params, state, m = step(params, state, as_batch(chunk))
            loss = float(m["loss"])
        return params, loss

    eval_batch = as_batch(full[:B * (S + 1)].reshape(B, S + 1))
    for t in range(args.rounds):
        models, sizes = [], []
        for corpus in corpora:
            m, _ = local_train(global_params, corpus, args.local_steps)
            models.append(m)
            sizes.append(len(corpus))
        # token-level AIGC: the RSU samples from the reference distribution
        aug, _ = local_train(global_params, full, args.local_steps)
        emd_bar = mean_emd(emds)
        global_params = aggregate(models, data_weights(sizes), aug, emd_bar)
        _, k2 = kappas(emd_bar)
        with torch.no_grad():
            ev = float(loss_fn(global_params, cfg, eval_batch)[0])
        print(f"  round {t}: global-eval loss {ev:.4f} (kappa2={k2:.3f})")
    print("[federated-lm] done — eq. (4) applied unchanged to an LM parameter tree")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
