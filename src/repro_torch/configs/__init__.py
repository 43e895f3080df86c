"""Architecture registry: ``get_config(name)`` resolves an assigned arch id."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (EncoderConfig, FrontendConfig, InputShape,
                                      LayerSpec, ModelConfig, MoEConfig, SHAPES,
                                      SSMConfig)

# arch id -> module name in this package
_MODULES = {
    "glm4-9b": "glm4_9b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "deepseek-7b": "deepseek_7b",
    "llama3.2-1b": "llama3_2_1b",
    "whisper-base": "whisper_base",
    "mamba2-370m": "mamba2_370m",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "smollm-135m": "smollm_135m",
    "mixtral-8x7b": "mixtral_8x7b",
    # the paper's own model (estimated geometry, see module docstring)
    "openpangu-7b-vl": "openpangu_7b_vl",
}

ASSIGNED_ARCHS = tuple(k for k in _MODULES if k != "openpangu-7b-vl")
ALL_ARCHS = tuple(_MODULES)

_cache: Dict[str, ModelConfig] = {}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    if name not in _cache:
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
        _cache[name] = mod.CONFIG
    return _cache[name]


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "FrontendConfig", "EncoderConfig",
    "LayerSpec", "InputShape", "SHAPES", "ASSIGNED_ARCHS", "ALL_ARCHS",
    "get_config", "get_shape",
]
