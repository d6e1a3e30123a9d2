"""Architecture registry of the port: `get_config("<arch-id>")`.

Only the architectures whose serving path has been ported are registered.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    ATTN_GLOBAL, ATTN_LOCAL, BLOCK_MLSTM, BLOCK_RGLRU, BLOCK_SLSTM,
    ModelConfig, MoEConfig,
)

# arch-id -> module name under repro_torch.configs
_ARCH_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
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
