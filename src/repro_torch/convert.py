"""Carry parameters across from the JAX package.

``repro.models.cnn.init_cnn_params`` and ``repro.models.transformer.
init_params`` draw from ``jax.random``, which no
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


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes: carried bit for bit
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def lm_params_from_numpy(tree, device="cuda"):
    """The JAX package's LM params (``repro.models.transformer.
    init_params``), as a nested dict of array-likes with the ``[L]``-stacked
    ``layers`` subtree (xLSTM: the list of ``blocks``), -> the same tree of
    tensors on ``device``, leaf for leaf; lists and tuples (xLSTM's
    blocks, the recurrent states of a cache) stay lists and tuples.
    Dtypes are kept: bf16 leaves bit for bit, RMSNorm scales f32 (the JAX
    side's ``arch.dtype`` picks the weights' dtype)."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(lm_params_from_numpy(v, device) for v in tree)
    return _leaf(tree, device)


def adamw_state_from_numpy(state: Dict[str, Any],
                           device="cuda") -> Dict[str, Any]:
    """The JAX package's AdamW state (``repro.optim.adamw.init`` /
    ``apply``: ``step``, the f32 moments ``mu`` and ``nu``, and
    ``residual`` when int8 compression is on), as array-likes -> the
    port's state on ``device``, leaf for leaf (``step`` a 0-d int32
    tensor)."""
    out = {"step": _leaf(state["step"], device).reshape(())}
    for k in ("mu", "nu", "residual"):
        if k in state:
            out[k] = lm_params_from_numpy(state[k], device)
    return out
