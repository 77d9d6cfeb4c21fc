"""Gated FFN (SwiGLU / GeGLU) — the dense part of ``repro.models.ffn``.
The mixture-of-experts layer waits for the MoE slice (ROADMAP)."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense_init

Params = Dict[str, Any]


def _act(name: str):
    if name == "silu":
        return lambda x: x * torch.sigmoid(x)       # jax.nn.silu's form
    return lambda x: F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def init_ffn(gen, d: int, d_ff: int, dtype, device) -> Params:
    return {
        "w_gate": _dense_init(gen, (d, d_ff), dtype, device),
        "w_up": _dense_init(gen, (d, d_ff), dtype, device),
        "w_down": _dense_init(gen, (d_ff, d), dtype, device),
    }


def ffn(params: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = _act(act)(torch.einsum("bsd,df->bsf", x, params["w_gate"]))
    u = torch.einsum("bsd,df->bsf", x, params["w_up"])
    return torch.einsum("bsf,fd->bsd", g * u, params["w_down"])
