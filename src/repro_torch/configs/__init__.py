"""Architecture registry of the port: `get_config("<arch-id>")` and shape
lookup.

Registered: the ten architectures of the JAX package (minicpm-2b,
llava-next-mistral-7b, gemma2-9b, whisper-tiny, grok-1-314b, gemma-2b,
xlstm-1.3b, recurrentgemma-9b, qwen1.5-0.5b, olmoe-1b-7b).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    ATTN_GLOBAL, ATTN_LOCAL, BLOCK_MLSTM, BLOCK_RGLRU, BLOCK_SLSTM, H100,
    HardwareSpec, INPUT_SHAPES, InputShape, ModelConfig, MoEConfig,
)

# arch-id -> module name under repro_torch.configs
_ARCH_MODULES = {
    "minicpm-2b": "minicpm_2b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "gemma2-9b": "gemma2_9b",
    "whisper-tiny": "whisper_tiny",
    "grok-1-314b": "grok_1_314b",
    "gemma-2b": "gemma_2b",
    "xlstm-1.3b": "xlstm_1_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "olmoe-1b-7b": "olmoe_1b_7b",
}

_cache: Dict[str, ModelConfig] = {}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _cache:
        if arch not in _ARCH_MODULES:
            raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
        mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
        _cache[arch] = mod.CONFIG
    return _cache[arch]


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
