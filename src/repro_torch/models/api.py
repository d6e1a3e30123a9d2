"""Model API of the port (the counterpart of the JAX package's
`models/api.py`): parameters, caches, the prefill / decode steps the
serving engine runs (under `torch.inference_mode()`, through the kernels
by default), and the loss and train step the launcher runs (with
autograd, through the plain torch route `impl="torch"`).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map


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


def make_loss_fn(cfg: ModelConfig, *, impl: str = "torch", remat: bool = False):
    """loss(params, batch) -> (ce + aux, {"ce", "aux"})."""
    def loss(params, batch):
        return tfm.loss_fn(params, cfg, batch, impl=impl, remat=remat)
    return loss


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *, impl: str = "torch",
                    remat: bool = False, clip_norm: float = 1.0):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics)
    with metrics {"loss", "ce", "aux", "grad_norm"}: the loss's gradient by
    autograd, clipped to `clip_norm` in global norm, then the optimizer's
    update. Parameters may come from `init_params` or a previous step.

    impl="kernel" raises: the JAX package's Pallas kernels have no
    gradient (ROADMAP.md Queue 3, reference defect 6), so neither do the
    port's kernels, and training runs impl="torch" as the JAX package
    trains on impl="jnp"."""
    if impl == "kernel":
        raise NotImplementedError(
            "training through the kernels: the JAX package's Pallas kernels have no "
            "gradient (ROADMAP.md Queue 3, reference defect 6), so the port's have "
            "none either; train with impl='torch'")
    loss_fn = make_loss_fn(cfg, impl=impl, remat=remat)

    def step(params, opt_state, batch):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            leaves = tree_leaves(live)
            loss, parts = loss_fn(live, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not read (llava's projector without patches)
        # gets a zero gradient, as jax.grad gives it; a sharded leaf's
        # gradient takes the leaf's layout (its pending sums reduced there)
        by_leaf = {id(p): torch.zeros_like(p) if g is None else _like(g, p)
                   for p, g in zip(leaves, grads)}
        with torch.no_grad():
            grads, gn = clip_by_global_norm(tree_map(lambda p: by_leaf[id(p)], live),
                                            clip_norm)
            params, opt_state = optimizer.update(grads, opt_state, params)
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), "grad_norm": gn}
        return params, opt_state, metrics

    return step


def _like(g, p):
    """g in p's layout where both are DTensors, else g."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _serving(step):
    """step under torch.inference_mode(); under torch.no_grad() where the
    parameters are DTensors (a sharded step), which inference mode does
    not admit. The values are the same."""
    @functools.wraps(step)
    def run(params, *args):
        sharded = isinstance(params["embed"], DTensor)
        with torch.no_grad() if sharded else torch.inference_mode():
            return step(params, *args)
    return run


def make_prefill_step(cfg: ModelConfig, *, impl: str = "kernel",
                      long_window: Optional[int] = None):
    """prefill(params, cache, batch) -> (last_logits [B,V], cache).

    impl: "kernel" (the kernels) or "torch" (the plain torch route, which
    the dry-run traces on the meta device; transformer's docstring).
    long_window: the gemma2 long-context variant, where global layers
    attend over the sliding window."""

    @_serving
    def prefill(params, cache, batch):
        hidden, cache, _ = tfm.forward(params, cfg, batch, cache=cache, impl=impl,
                                       long_window=long_window, logits_mode="hidden")
        return tfm.unembed(params, cfg, hidden[:, -1:])[:, 0], cache

    return prefill


def make_decode_step(cfg: ModelConfig, *, impl: str = "kernel",
                     long_window: Optional[int] = None):
    """decode(params, cache, tokens [B,1], positions [B,1] int32)
    -> (logits [B,V], cache). One new token against the existing cache;
    impl as in `make_prefill_step`."""

    @_serving
    def decode(params, cache, tokens, positions):
        batch = {"tokens": tokens, "positions": positions}
        hidden, cache, _ = tfm.forward(params, cfg, batch, cache=cache, impl=impl,
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
