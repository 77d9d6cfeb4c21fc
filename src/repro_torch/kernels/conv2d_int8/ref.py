"""Plain PyTorch version of the int8 conv engine, exact on CPU and CUDA.

PyTorch has no integer convolution on CUDA, so the dense conv is a loop
over the k_h*k_w taps of float64 ``[.., C] @ [C, C_out]`` products: every
product and partial sum is an integer below 2^53 (the largest sum on the
main path, VGG-16's fc0 over 7*7*512 = 25088 inputs, is at most
127*127*25088 ~ 4.05e8, past float32's 2^24 but far below 2^53), so
float64 is exact in any order.
The depthwise conv is an elementwise int32 multiply-add per tap.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def same_padded_width(n: int, k: int, stride: int) -> int:
    """Padded extent of one spatial dim under SAME padding (the odd pixel
    goes to the bottom/right)."""
    out = -(-n // stride)
    return n + max((out - 1) * stride + k - n, 0)


def same_out_and_pad(n: int, k: int, stride: int):
    """(output extent, leading pad) of one SAME-padded dim."""
    pad = same_padded_width(n, k, stride) - n
    return (n + pad - k) // stride + 1, pad // 2


def same_pad(x: torch.Tensor, k_h: int, k_w: int, stride: int,
             value: int = 0) -> torch.Tensor:
    """SAME-pad an NHWC map: ``pad // 2`` at the top/left, the rest at the
    bottom/right."""
    B, H, W, C = x.shape
    pad_h = same_padded_width(H, k_h, stride) - H
    pad_w = same_padded_width(W, k_w, stride) - W
    return F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2,
                     pad_h // 2, pad_h - pad_h // 2), value=value)


def tap_slice(xp: torch.Tensor, i: int, j: int, stride: int, h_out: int,
              w_out: int) -> torch.Tensor:
    """Rows i, i+s, ... and cols j, j+s, ... of a padded NHWC map."""
    return xp[:, i:i + (h_out - 1) * stride + 1:stride,
              j:j + (w_out - 1) * stride + 1:stride, :]


def conv2d_int8_ref(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                    padding: str = "SAME",
                    depthwise: bool = False) -> torch.Tensor:
    """x: [B,H,W,C] int8; w: [kh,kw,C,Co] int8 (or [kh,kw,1,C] when
    ``depthwise``) -> int32 [B,H',W',Co]."""
    k_h, k_w = w.shape[:2]
    if padding == "SAME":
        xp = same_pad(x, k_h, k_w, stride)
    elif padding == "VALID":
        xp = x
    else:
        raise ValueError(f"unknown padding {padding!r}")
    h_out = (xp.shape[1] - k_h) // stride + 1
    w_out = (xp.shape[2] - k_w) // stride + 1
    if depthwise:
        acc = torch.zeros((x.shape[0], h_out, w_out, x.shape[3]),
                          dtype=torch.int32, device=x.device)
        for i in range(k_h):
            for j in range(k_w):
                cols = tap_slice(xp, i, j, stride, h_out, w_out)
                acc += cols.to(torch.int32) * w[i, j, 0].to(torch.int32)
        return acc
    xf = xp.to(torch.float64)
    wf = w.to(torch.float64)
    acc = None
    for i in range(k_h):
        for j in range(k_w):
            term = tap_slice(xf, i, j, stride, h_out, w_out) @ wf[i, j]
            acc = term if acc is None else acc.add_(term)
    return acc.to(torch.int32)
