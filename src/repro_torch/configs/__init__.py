"""Architecture registry: one module per assigned architecture.

A copy of ``repro.configs`` (plain dataclasses, no framework), kept in the
port so that it imports nothing of the JAX package."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      ParallelConfig, SHAPES, ShapeConfig,
                                      SSMConfig, TrainConfig, reduced)

ARCH_IDS: List[str] = [
    "falcon_mamba_7b",
    "mixtral_8x22b",
    "deepseek_v3_671b",
    "internvl2_2b",
    "hymba_1_5b",
    "deepseek_67b",
    "yi_9b",
    "starcoder2_7b",
    "llama3_2_1b",
    "whisper_base",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES.update({
    "falcon-mamba-7b": "falcon_mamba_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "internvl2-2b": "internvl2_2b",
    "hymba-1.5b": "hymba_1_5b",
    "deepseek-67b": "deepseek_67b",
    "yi-9b": "yi_9b",
    "starcoder2-7b": "starcoder2_7b",
    "llama3.2-1b": "llama3_2_1b",
    "whisper-base": "whisper_base",
})


def get_config(arch: str) -> ModelConfig:
    arch_id = _ALIASES.get(arch, arch)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
