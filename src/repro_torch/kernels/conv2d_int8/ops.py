"""Wrappers: SAME int8 conv (+ fused requant) on the CUDA kernel or its
plain version.

``stream=True`` selects the HBM-streamed weight tier (taps re-read once
per output row through an ``n_buffers``-deep shared-memory ring); the
placement plan (core/schedule.py) flips that switch per layer.  A CPU
tensor runs the plain version in ``ref.py``; a CUDA tensor launches
``csrc/conv2d_int8.cu`` or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_int8.ref import (conv2d_int8_ref,
                                                 same_out_and_pad,
                                                 same_padded_width)
from repro_torch.kernels.quant import reciprocal, requant_epilogue

__all__ = ["conv2d_int8", "conv2d_int8_requant", "same_padded_width",
           "smem_bytes", "KERNEL_PINNED", "KERNEL_STREAM"]

KERNEL_PINNED = "conv2d_int8_pinned"     # replaces _conv_kernel
KERNEL_STREAM = "conv2d_int8_stream"     # replaces _conv_stream_kernel
MAX_SMEM_BYTES = 232448                  # what one H100 block may claim
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv2d_int8")
    if not getattr(lib, "_typed", False):
        lib.conv2d_int8_launch.argtypes = \
            [_P, _P, _P, _P, _F, _F, _P, _P, _P] + [_I] * 15 + [_P]
        lib.conv2d_int8_launch.restype = _I
        lib._typed = True
    return lib


def smem_bytes(c_in: int, w_out: int, k_h: int, k_w: int, stride: int,
               stream: bool, n_buffers: int) -> int:
    """Shared memory one CTA of the CUDA kernel claims (mirrors
    ``smem_bytes`` in ``csrc/conv2d_int8.cu``)."""
    cp = (c_in + 3) // 4 * 4
    wp = (w_out - 1) * stride + k_w
    taps = k_h * k_w
    nb = min(n_buffers, taps) if stream else taps
    return nb * cp * 32 + k_h * wp * (cp // 4 + 1) * 4


def _launch(x, w, w_scale, bias, act_scale: float, *, stride: int,
            stream: bool, n_buffers: int, relu: bool, raw: bool,
            want_float: bool):
    B, H, W, C = x.shape
    k_h, k_w, w_cin, c_out = w.shape
    if w_cin != C:
        raise ValueError(f"weights {tuple(w.shape)} do not take C={C}")
    if c_out % 4:
        raise ValueError(f"C_out={c_out} must be a multiple of 4")
    if n_buffers < 1:
        raise ValueError("n_buffers must be >= 1")
    h_out, pad_t = same_out_and_pad(H, k_h, stride)
    w_out, pad_l = same_out_and_pad(W, k_w, stride)
    if w_out > 256:
        raise ValueError(f"output width {w_out} > 256 is not supported")
    smem = smem_bytes(C, w_out, k_h, k_w, stride, stream, n_buffers)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"conv needs {smem} B of shared memory per block, "
                         f"more than {MAX_SMEM_BYTES}")
    dev = x.device
    _build.check_cuda_tensor(x, "x", torch.int8, dev)
    _build.check_cuda_tensor(w, "w", torch.int8, dev)
    shape = (B, h_out, w_out, c_out)
    out_q = out_f = out_i = None
    if raw:
        out_i = torch.empty(shape, dtype=torch.int32, device=dev)
    else:
        _build.check_cuda_tensor(w_scale, "w_scale", torch.float32, dev)
        _build.check_cuda_tensor(bias, "bias", torch.float32, dev)
        if w_scale.numel() != c_out or bias.numel() != c_out:
            raise ValueError("w_scale and bias need C_out entries")
        out_q = torch.empty(shape, dtype=torch.int8, device=dev)
        if want_float:
            out_f = torch.empty(shape, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _lib().conv2d_int8_launch(
        ptr(x), ptr(w), ptr(w_scale), ptr(bias), act_scale,
        0.0 if raw else reciprocal(act_scale), ptr(out_q),
        ptr(out_f), ptr(out_i), B, H, W, C, h_out, w_out, c_out, k_h, k_w,
        stride, pad_t, pad_l, int(stream), n_buffers, int(relu),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "conv2d_int8")
    _build.count_launch(KERNEL_STREAM if stream else KERNEL_PINNED)
    return out_i if raw else (out_q, out_f)


def conv2d_int8(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                stream: bool = False, n_buffers: int = 2,
                depthwise: bool = False) -> torch.Tensor:
    """SAME conv, int8 NHWC in / int32 out.  ``w`` is HWIO, or
    ``[k_h, k_w, 1, C]`` with ``depthwise=True``."""
    if _build.runs_plain(x):
        return conv2d_int8_ref(x, w, stride=stride, depthwise=depthwise)
    if depthwise:
        raise NotImplementedError(
            "depthwise conv has no CUDA kernel yet; run it on the CPU")
    return _launch(x, w, None, None, 0.0, stride=stride, stream=stream,
                   n_buffers=n_buffers, relu=False, raw=True,
                   want_float=False)


def conv2d_int8_requant(x: torch.Tensor, w: torch.Tensor,
                        w_scale: torch.Tensor, bias: torch.Tensor,
                        act_scale: float = 0.05, *, stride: int = 1,
                        relu: bool = True, stream: bool = False,
                        n_buffers: int = 2, depthwise: bool = False,
                        want_float: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The full layer engine: conv + per-channel dequant + bias + relu +
    requantize to int8.  Returns (int8, f32 pre-quant values or None);
    the f32 values are produced only when ``want_float``."""
    if _build.runs_plain(x):
        y = conv2d_int8_ref(x, w, stride=stride, depthwise=depthwise)
        y_q, y_f = requant_epilogue(y, w_scale, bias, act_scale=act_scale,
                                    relu=relu)
        return y_q, (y_f if want_float else None)
    if depthwise:
        raise NotImplementedError(
            "depthwise conv has no CUDA kernel yet; run it on the CPU")
    return _launch(x, w, w_scale, bias, act_scale, stride=stride,
                   stream=stream, n_buffers=n_buffers, relu=relu, raw=False,
                   want_float=want_float)
