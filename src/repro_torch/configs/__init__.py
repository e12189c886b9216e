"""Architecture registry (port of ``src/repro/configs/__init__.py``).

Lists only the architectures the port serves; the others join as their
slices land.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import MLAConfig, ModelConfig, SSMConfig  # noqa: F401

_ARCH_MODULES: Dict[str, str] = {
    "qwen2-1.5b": "qwen2_1_5b",
    "mamba2-1.3b": "mamba2_1_3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen1.5-110b": "qwen1_5_110b",
    "mixtral-8x22b": "mixtral_8x22b",
    "chameleon-34b": "chameleon_34b",
    "minicpm3-4b": "minicpm3_4b",
    "gemma2-9b": "gemma2_9b",
    "zamba2-7b": "zamba2_7b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port serves: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG
