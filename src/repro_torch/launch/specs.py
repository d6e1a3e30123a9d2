"""Input specs for every (architecture x input shape) pair on the meta
device: tensors with a shape and a dtype and no storage, the counterpart
of the JAX package's `jax.eval_shape` / `ShapeDtypeStruct` specs. The
dry-run traces the steps against them; nothing is allocated.

Shape semantics (assignment):
  train_4k      train_step   tokens/targets/mask [B, S]
  prefill_32k   prefill      tokens [B, S] + empty cache of capacity S
  decode_32k    serve_step   ONE token + cache of seq_len
  long_500k     serve_step   ONE token + cache of seq_len (sub-quadratic
                             archs only; gemma2 runs its documented
                             local-window serving variant)

[vlm]/[audio] carve-out: patch/frame embeddings appear as precomputed
inputs of the right shape (the frontend itself is stubbed).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.metatrace import MetaTrace
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import VISION_EMBED_DIM

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def params_specs(cfg: ModelConfig, dtype=torch.bfloat16):
    # MetaTrace answers the init's repeated ops (one per expert and layer)
    with MetaTrace():
        return tfm.init_params(None, cfg, dtype, device=META)


def opt_specs(cfg: ModelConfig, optimizer, dtype=torch.bfloat16):
    params = params_specs(cfg, dtype)
    with MetaTrace():
        return optimizer.init(params)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    with MetaTrace():
        return tfm.init_cache(cfg, batch, max_len, dtype, META)


def batch_specs(cfg: ModelConfig, shape: InputShape, *, train: bool,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    text = S
    out: Dict[str, Any] = {}
    if cfg.modality == "vision":
        text = S - cfg.frontend_tokens
        out["patch_embeds"] = _spec((B, cfg.frontend_tokens, VISION_EMBED_DIM), dtype)
    if cfg.modality == "audio" and train:
        out["frames"] = _spec((B, cfg.encoder_seq, cfg.d_model), dtype)
    out["tokens"] = _spec((B, text), torch.int32)
    if train:
        out["targets"] = _spec((B, text), torch.int32)
        out["mask"] = _spec((B, text), torch.float32)
    return out


def input_specs(cfg: ModelConfig, shape: InputShape, optimizer=None,
                dtype=torch.bfloat16) -> Tuple[Tuple, str]:
    """Returns (args_specs, step_kind) for the step of this shape.

    train:   step(params, opt_state, batch)
    prefill: step(params, cache, batch)
    decode:  step(params, cache, tokens, positions)
    """
    if shape.kind == "train":
        if optimizer is None:
            raise ValueError("a train shape needs the optimizer")
        return ((params_specs(cfg, dtype), opt_specs(cfg, optimizer, dtype),
                 batch_specs(cfg, shape, train=True, dtype=dtype)), "train")
    if shape.kind == "prefill":
        return ((params_specs(cfg, dtype),
                 cache_specs(cfg, shape.global_batch, shape.seq_len, dtype),
                 batch_specs(cfg, shape, train=False, dtype=dtype)), "prefill")
    # decode: one new token against a cache of seq_len
    B = shape.global_batch
    return ((params_specs(cfg, dtype),
             cache_specs(cfg, B, shape.seq_len, dtype),
             _spec((B, 1), torch.int32), _spec((B, 1), torch.int32)), "decode")


def runnable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether this (arch, shape) pair is in scope (long_500k policy)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, cfg.long_context_note or "full attention; skipped per spec"
    return True, ""
