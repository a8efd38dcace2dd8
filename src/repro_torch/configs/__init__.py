"""Model configurations the port supports.

``pixellink_std`` holds the scene-text-detection models; the LM
architectures resolve by id (``--arch <id>``) through this registry.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import (SHAPES, ArchConfig, ShapeConfig, input_specs,
                   shape_applicable)

# arch id -> module name
ARCH_MODULES: Dict[str, str] = {
    "grok-1-314b": "grok_1_314b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen2.5-14b": "qwen2_5_14b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "internlm2-1.8b": "internlm2_1_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "whisper-tiny": "whisper_tiny",
    "internvl2-76b": "internvl2_76b",
    "zamba2-2.7b": "zamba2_2_7b",
    "mamba2-370m": "mamba2_370m",
    "zamba2-7b": "zamba2_7b",
}

ARCH_IDS: List[str] = list(ARCH_MODULES)


def _mod(arch: str):
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")


def get_config(arch: str) -> ArchConfig:
    return _mod(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _mod(arch).SMOKE


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = [
    "ARCH_IDS", "ARCH_MODULES", "SHAPES", "ArchConfig", "ShapeConfig",
    "all_configs", "get_config", "get_smoke_config", "input_specs",
    "shape_applicable",
]
