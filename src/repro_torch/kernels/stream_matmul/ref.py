"""Plain PyTorch version of the streamed-weight matmul.

The result type is the JAX package's: int32 for int8 x int8, otherwise
``torch.promote_types(x.dtype, w.dtype)`` (bf16 for bf16 x bf16, f32
for f32 x f32 and for f32 x bf16 in either order).  int8 inputs
accumulate exactly: a float64 product of int8 operands is exact for K up
to 2^53 / 127^2, in any summation order, on CPU and CUDA alike (PyTorch
has no integer matmul on CUDA).  Float inputs are summed in float64,
rounded to float32 and then cast to the result type.
"""
from __future__ import annotations

import torch


def result_dtype(x_dtype: torch.dtype, w_dtype: torch.dtype) -> torch.dtype:
    """int32 for int8 x int8, else the promoted operand type."""
    if x_dtype == torch.int8 and w_dtype == torch.int8:
        return torch.int32
    return torch.promote_types(x_dtype, w_dtype)


def stream_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [M, K] @ w: [K, N] -> ``result_dtype(x.dtype, w.dtype)``."""
    acc = x.to(torch.float64) @ w.to(torch.float64)
    out = result_dtype(x.dtype, w.dtype)
    if out == torch.int32:
        return acc.to(torch.int32)
    return acc.to(torch.float32).to(out)
