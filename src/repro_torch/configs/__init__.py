"""CNN configurations (the paper's networks and the executable mini nets)
and the registry of the LM architectures the port can run.

``get_arch("<id>")`` accepts the public ids with dashes/dots, as the JAX
package's registry does, and raises ``KeyError`` for an id the port does
not run yet.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, MLAConfig,  # noqa: F401
                                      MoEConfig, ShapeConfig, SSMConfig)
from repro_torch.configs.cnn import (CNN_CONFIGS, CNNConfig,  # noqa: F401
                                     ConvLayerSpec, get_cnn)

# the archs whose whole path the port runs (ROADMAP Queue 1 lists the rest)
_ARCH_MODULES = {
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
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
