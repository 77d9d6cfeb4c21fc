"""Wrappers: SAME maxpool and global average pool on the CUDA kernels or
their plain versions.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
``csrc/pool_int8.cu`` or raises.  Padding geometry comes from the conv
ops' ``same_padded_width``; maxpool pads with int8 -128.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_int8.ref import same_out_and_pad
from repro_torch.kernels.quant import reciprocal
from repro_torch.kernels.pool_int8.ref import (global_avgpool_int8_ref,
                                               maxpool_int8_ref)

__all__ = ["maxpool_int8", "global_avgpool_int8", "KERNEL_MAXPOOL",
           "KERNEL_GAP"]

KERNEL_MAXPOOL = "maxpool_int8"          # replaces _maxpool_kernel
KERNEL_GAP = "global_avgpool_int8"       # replaces _gap_kernel
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("pool_int8")
    if not getattr(lib, "_typed", False):
        lib.maxpool_int8_launch.argtypes = [_P, _P] + [_I] * 10 + [_P]
        lib.maxpool_int8_launch.restype = _I
        lib.global_avgpool_int8_launch.argtypes = [_P, _P] + [_I] * 4 \
            + [_F, _F, _P]
        lib.global_avgpool_int8_launch.restype = _I
        lib._typed = True
    return lib


def maxpool_int8(x: torch.Tensor, *, k: int, stride: int) -> torch.Tensor:
    """SAME maxpool, int8 in / int8 out.
    x: [B, H, W, C] -> [B, ceil(H/s), ceil(W/s), C]."""
    if _build.runs_plain(x):
        return maxpool_int8_ref(x, k=k, stride=stride)
    B, H, W, C = x.shape
    if C % 4:
        raise ValueError(f"maxpool kernel needs C % 4 == 0, got C={C}")
    _build.check_cuda_tensor(x, "x", torch.int8, x.device)
    h_out, pad_t = same_out_and_pad(H, k, stride)
    w_out, pad_l = same_out_and_pad(W, k, stride)
    out = torch.empty((B, h_out, w_out, C), dtype=torch.int8,
                      device=x.device)
    err = _lib().maxpool_int8_launch(
        x.data_ptr(), out.data_ptr(), B, H, W, C, h_out, w_out, k, stride,
        pad_t, pad_l, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "maxpool_int8")
    _build.count_launch(KERNEL_MAXPOOL)
    return out


def global_avgpool_int8(x: torch.Tensor, *,
                        act_scale: float = 0.05) -> torch.Tensor:
    """Global average pool + activation requantization, int8 in/out.
    x: [B, H, W, C] -> [B, 1, 1, C]."""
    if _build.runs_plain(x):
        return global_avgpool_int8_ref(x, act_scale=act_scale)
    B, H, W, C = x.shape
    _build.check_cuda_tensor(x, "x", torch.int8, x.device)
    out = torch.empty((B, 1, 1, C), dtype=torch.int8, device=x.device)
    err = _lib().global_avgpool_int8_launch(
        x.data_ptr(), out.data_ptr(), B, H, W, C, reciprocal(H * W),
        reciprocal(act_scale),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "global_avgpool_int8")
    _build.count_launch(KERNEL_GAP)
    return out
