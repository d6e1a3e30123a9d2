"""Model API of the port (the counterpart of the JAX package's
`models/api.py`): parameters, caches, and the prefill / decode steps used by
the serving engine. Inference only: the steps run under
`torch.inference_mode()`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


def resolve_device(device) -> torch.device:
    """The device to run on; raises where CUDA is asked for and absent rather
    than running somewhere else."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain kernel versions "
                "on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def require_params_on(params, device: torch.device):
    """Raises unless the parameters lie on `device`."""
    if params["embed"].device != device:
        raise ValueError(f"parameters lie on {params['embed'].device}, "
                         f"the call runs on {device}")


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                device="cuda"):
    """Random parameters on `device`, drawn from `gen`, which must lie there."""
    device = resolve_device(device)
    if gen.device != device:
        raise ValueError(f"generator lies on {gen.device}, the parameters "
                         f"go to {device}")
    return tfm.init_params(gen, cfg, dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cuda"):
    return tfm.init_cache(cfg, batch, max_len, dtype, resolve_device(device))


def make_prefill_step(cfg: ModelConfig, *, long_window: Optional[int] = None):
    """prefill(params, cache, batch) -> (last_logits [B,V], cache).

    long_window: the gemma2 long-context variant, where global layers
    attend over the sliding window."""

    @torch.inference_mode()
    def prefill(params, cache, batch):
        hidden, cache, _ = tfm.forward(params, cfg, batch, cache=cache,
                                       long_window=long_window, logits_mode="hidden")
        return tfm.unembed(params, cfg, hidden[:, -1:])[:, 0], cache

    return prefill


def make_decode_step(cfg: ModelConfig, *, long_window: Optional[int] = None):
    """decode(params, cache, tokens [B,1], positions [B,1] int32)
    -> (logits [B,V], cache). One new token against the existing cache."""

    @torch.inference_mode()
    def decode(params, cache, tokens, positions):
        batch = {"tokens": tokens, "positions": positions}
        hidden, cache, _ = tfm.forward(params, cfg, batch, cache=cache,
                                       long_window=long_window, logits_mode="hidden")
        return tfm.unembed(params, cfg, hidden)[:, 0], cache

    return decode


@torch.inference_mode()
def greedy_generate(cfg, params, prompt, steps: int, *,
                    max_len: Optional[int] = None, dtype=torch.float32,
                    device="cuda"):
    """Reference generation loop (prefill + greedy decode) on `device`, where
    the parameters must lie. prompt: [B,S] integer tensor. Returns
    [B, steps]."""
    device = resolve_device(device)
    require_params_on(params, device)
    B, S = prompt.shape
    cache = init_cache(cfg, B, max_len or (S + steps), dtype, device)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    logits, cache = prefill(params, cache, {"tokens": prompt.to(device)})
    out = [torch.argmax(logits, -1)]
    pos = torch.full((B, 1), S, dtype=torch.int32, device=device)
    for _ in range(steps - 1):
        logits, cache = decode(params, cache, out[-1][:, None], pos)
        out.append(torch.argmax(logits, -1))
        pos = pos + 1
    return torch.stack(out, dim=1)
