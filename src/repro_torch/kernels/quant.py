"""The single requantization epilogue every int8 layer engine shares.

HPIPE's layer contract (models/cnn.py): int32 conv/matmul accumulator ->
per-output-channel dequant + bias -> optional relu -> requantize to int8
for the next engine.  The CUDA kernels fuse this epilogue; this is its
plain version, which the CPU path and the kernels' checks run.

Rounding follows the JAX reference, where XLA evaluates
``y * (w_scale * act_scale) + bias`` as one fused multiply-add:

  * ``scale = w_scale * act_scale`` is an f32 product;
  * ``y`` is rounded to f32 first (as ``astype(float32)`` does), then
    ``y * scale + bias`` is formed in float64 and rounded once to f32
    (the product of two f32 values is exact in float64);
  * ``y / act_scale`` is a multiply by the f32 reciprocal
    ``f32(1) / f32(act_scale)``: XLA rewrites a divide by a constant that
    way, and an IEEE divide differs from it on rare ties (4 of 262,144
    sums at ``act_scale=0.05``); then round half to even and clip to
    +-127.
"""
from __future__ import annotations

import numpy as np
import torch


def reciprocal(v: float) -> float:
    """``f32(1) / f32(v)``, correctly rounded: the multiplier XLA puts in
    place of a divide by the constant ``v`` (exactly representable in
    f32, so multiplying an f32 tensor by it rounds once)."""
    return float(np.float32(1) / np.float32(v))


def requant_epilogue(y: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor, act_scale: float = 0.05,
                     relu: bool = True):
    """y: int32 accumulator [..., C_out].  Returns (int8 requantized,
    float32 pre-quant activations)."""
    act = torch.full((1,), act_scale, dtype=torch.float32, device=y.device)
    scale = w_scale.to(torch.float32) * act                  # f32 product
    y_f = (y.to(torch.float32).to(torch.float64) * scale.to(torch.float64)
           + bias.to(torch.float64)).to(torch.float32)
    if relu:
        y_f = torch.relu(y_f)
    y_q = torch.clamp(torch.round(y_f * reciprocal(act_scale)),
                      -127, 127).to(torch.int8)
    return y_q, y_f
