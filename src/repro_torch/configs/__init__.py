"""Architecture registry of the port: `get_config("<arch-id>")`.

Registered: the nine attention and RG-LRU architectures of the JAX
package (minicpm-2b, llava-next-mistral-7b, gemma2-9b, whisper-tiny,
grok-1-314b, gemma-2b, recurrentgemma-9b, qwen1.5-0.5b, olmoe-1b-7b).
`xlstm-1.3b` is known but not ported: `get_config` raises
NotImplementedError naming its ROADMAP item.
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
    "minicpm-2b": "minicpm_2b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "gemma2-9b": "gemma2_9b",
    "whisper-tiny": "whisper_tiny",
    "grok-1-314b": "grok_1_314b",
    "gemma-2b": "gemma_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "olmoe-1b-7b": "olmoe_1b_7b",
}
# architectures of the JAX package whose blocks the port does not carry yet
_NOT_PORTED = {
    "xlstm-1.3b": "xLSTM blocks (mLSTM/sLSTM) are not ported yet; see "
                  "ROADMAP.md Queue 1 item 2",
}

_cache: Dict[str, ModelConfig] = {}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _cache:
        if arch in _NOT_PORTED:
            raise NotImplementedError(f"{arch}: {_NOT_PORTED[arch]}")
        if arch not in _ARCH_MODULES:
            raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
        mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
        _cache[arch] = mod.CONFIG
    return _cache[arch]
