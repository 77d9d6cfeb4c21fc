"""CNN configurations (the paper's networks and the executable mini nets)
and the registry of the LM architectures the port can run, with the
dry run's input shapes (``SHAPES``, ``shape_applicable``,
``reduced_shape``).

``get_arch("<id>")`` accepts the public ids with dashes/dots, as the JAX
package's registry does, and raises ``KeyError`` for an unknown id.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (SHAPES, ArchConfig,  # noqa: F401
                                      MLAConfig, MoEConfig, ShapeConfig,
                                      SSMConfig, reduced_shape,
                                      shape_applicable)
from repro_torch.configs.cnn import (CNN_CONFIGS, CNNConfig,  # noqa: F401
                                     ConvLayerSpec, get_cnn)

_ARCH_MODULES = {
    "command-r-plus-104b": "command_r_plus_104b",
    "gemma2-9b": "gemma2_9b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2-72b": "qwen2_72b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "hymba-1.5b": "hymba_1_5b",
    "internvl2-26b": "internvl2_26b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "xlstm-125m": "xlstm_125m",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_arch(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[key]}")
    return mod.CONFIG


def all_archs() -> Dict[str, ArchConfig]:
    return {k: get_arch(k) for k in ARCH_IDS}


__all__ = [
    "ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "ShapeConfig",
    "SHAPES", "shape_applicable", "reduced_shape", "ARCH_IDS", "get_arch",
    "all_archs", "CNNConfig", "ConvLayerSpec", "CNN_CONFIGS", "get_cnn",
]
