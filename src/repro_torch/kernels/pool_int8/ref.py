"""Plain PyTorch versions of the pooling topology nodes.

  * maxpool: max over a SAME-padded k x k window, padded with int8 -128
    (the identity of max; a SAME window always holds a real element);
  * global average pool: exact int32 channel sums, the mean as an f32
    multiply by ``1 / (H*W)``, then the activation quantization (multiply
    by ``1 / act_scale``, round half to even, clip) to int8.  Both
    divides are by constants, which XLA turns into multiplies by the f32
    reciprocal (see ``kernels/quant.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.conv2d_int8.ref import same_pad, tap_slice
from repro_torch.kernels.quant import reciprocal


def maxpool_int8_ref(x: torch.Tensor, *, k: int,
                     stride: int) -> torch.Tensor:
    """x: [B, H, W, C] int8 -> [B, ceil(H/s), ceil(W/s), C] int8."""
    xp = same_pad(x, k, k, stride, value=-128)
    h_out = (xp.shape[1] - k) // stride + 1
    w_out = (xp.shape[2] - k) // stride + 1
    acc = tap_slice(xp, 0, 0, stride, h_out, w_out)
    for i in range(k):
        for j in range(k):
            acc = torch.maximum(acc, tap_slice(xp, i, j, stride, h_out,
                                               w_out))
    return acc.contiguous()


def global_avgpool_int8_ref(x: torch.Tensor, *,
                            act_scale: float = 0.05) -> torch.Tensor:
    """x: [B, H, W, C] int8 -> [B, 1, 1, C] int8 (requantized mean)."""
    B, H, W, C = x.shape
    s = x.to(torch.int32).sum(dim=(1, 2), keepdim=True)      # exact
    m = s.to(torch.float32) * reciprocal(H * W)
    return torch.clamp(torch.round(m * reciprocal(act_scale)),
                       -127, 127).to(torch.int8)
