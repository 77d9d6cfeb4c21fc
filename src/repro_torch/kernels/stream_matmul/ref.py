"""Plain PyTorch version of the streamed-weight matmul.

int8 inputs accumulate exactly: a float64 product of int8 operands is
exact for K up to 2^53 / 127^2, in any summation order, on CPU and CUDA
alike (PyTorch has no integer matmul on CUDA).  Float inputs are summed
in float64 and rounded to float32.
"""
from __future__ import annotations

import torch


def stream_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [M, K] @ w: [K, N] -> int32 for int8 inputs, else float32."""
    acc = x.to(torch.float64) @ w.to(torch.float64)
    if x.dtype == torch.int8 and w.dtype == torch.int8:
        return acc.to(torch.int32)
    return acc.to(torch.float32)
