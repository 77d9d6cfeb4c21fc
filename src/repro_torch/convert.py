"""Carry parameters across from the JAX package.

``repro.models.cnn.init_cnn_params`` draws from ``jax.random``, which no
PyTorch generator reproduces; tests and comparisons therefore make the
parameters once, convert them to numpy, and hand them to the port.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_numpy(tree: Dict[str, Dict[str, Any]],
                      device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer: {"w", "w_scale", "bias"}}`` of array-likes -> the same
    tree of tensors on ``device``, dtypes kept (int8 weights, f32 scales
    and biases)."""
    return {layer: {k: torch.from_numpy(np.array(v, copy=True)).to(device)
                    for k, v in leaves.items()}
            for layer, leaves in tree.items()}
