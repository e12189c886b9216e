"""Architecture registry (port of ``src/repro/configs/__init__.py``).

Lists the architectures the port serves: all ten of the JAX registry.
:func:`all_cells` gives the dry run's (arch × shape) cells in the
reference's order, which is not :func:`list_archs`' order.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    MLAConfig,
    ModelConfig,
    PREFILL_32K,
    SHAPES,
    SSMConfig,
    ShapeSpec,
    TRAIN_4K,
    shape_applicable,
)

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
    "whisper-tiny": "whisper_tiny",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port serves: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


# the reference registry's order, in which its dry run lists the cells
_CELL_ORDER = ("mixtral-8x22b", "mixtral-8x7b", "mamba2-1.3b", "qwen2-1.5b",
               "qwen1.5-110b", "minicpm3-4b", "gemma2-9b", "zamba2-7b",
               "whisper-tiny", "chameleon-34b")


def all_cells():
    """Every (arch, shape name, applies, reason) cell — 40 in all."""
    cells = []
    for arch in _CELL_ORDER:
        cfg = get_config(arch)
        for shape in ALL_SHAPES:
            ok, why = shape_applicable(cfg, shape)
            cells.append((arch, shape.name, ok, why))
    return cells
