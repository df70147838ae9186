"""Architecture registry: ``get(name)`` -> ArchConfig.

The same names and aliases as ``repro.configs``, and all ten of its
architectures: the dense qwen2-1.5b, qwen3-1.7b, gemma3-1b and
granite-34b; the mixture-of-experts mixtral-8x22b and deepseek-v2-236b
(MLA, a dense first layer); the recurrent recurrentgemma-9b (RG-LRU and
local attention) and xlstm-125m (mLSTM and sLSTM); the encoder-decoder
whisper-base and the vision-stub internvl2-26b.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, MlaConfig, MoeConfig, ShapeSpec

ARCH_NAMES = (
    "gemma3_1b",
    "granite_34b",
    "qwen3_1_7b",
    "qwen2_1_5b",
    "mixtral_8x22b",
    "deepseek_v2_236b",
    "internvl2_26b",
    "recurrentgemma_9b",
    "whisper_base",
    "xlstm_125m",
)

_ALIASES = {n.replace("_", "-"): n for n in ARCH_NAMES}
_ALIASES.update({"qwen3-1.7b": "qwen3_1_7b", "qwen2-1.5b": "qwen2_1_5b"})


def get(name: str) -> ArchConfig:
    name = _ALIASES.get(name, name)
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def names() -> tuple:
    return ARCH_NAMES


__all__ = ["ArchConfig", "MoeConfig", "MlaConfig", "ShapeSpec", "get",
           "names", "ARCH_NAMES"]
