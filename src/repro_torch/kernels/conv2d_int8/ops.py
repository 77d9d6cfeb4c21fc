"""Wrappers: SAME int8 conv (+ fused requant) on the CUDA kernel or its
plain version.

``stream=True`` selects the HBM-streamed weight tier (taps re-read once
per output row through an ``n_buffers``-deep shared-memory ring); the
placement plan (core/schedule.py) flips that switch per layer.  A CPU
tensor runs the plain version in ``ref.py``; a CUDA tensor launches
``csrc/conv2d_int8.cu`` (dense) or ``csrc/dwconv_int8.cu``
(``depthwise=True``) or raises.
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
           "smem_bytes", "dw_quads", "dw_smem_bytes", "KERNEL_PINNED",
           "KERNEL_STREAM", "KERNEL_DW_PINNED", "KERNEL_DW_STREAM"]

KERNEL_PINNED = "conv2d_int8_pinned"     # replaces _conv_kernel
KERNEL_STREAM = "conv2d_int8_stream"     # replaces _conv_stream_kernel
KERNEL_DW_PINNED = "dwconv_int8_pinned"  # replaces _dwconv_kernel
KERNEL_DW_STREAM = "dwconv_int8_stream"  # replaces _dwconv_stream_kernel
DW_THREADS = 128                         # threads per CTA of dw_kernel
MAX_SMEM_BYTES = 232448                  # what one H100 block may claim
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``; both launch functions take the
    same argument list: 4 pointers, 2 floats, 3 output pointers, 15 ints
    and the stream."""
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = [_P, _P, _P, _P, _F, _F, _P, _P, _P] + [_I] * 15 + [_P]
        fn.restype = _I
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


def dw_quads(c: int, w_out: int) -> int:
    """Channel tile of the depthwise kernel, in quads of channels (8, 16
    or 32): the one that leaves the fewest of a CTA's thread slots idle
    over (channel tiles x lanes x columns per lane), the smaller on a tie
    (more CTAs).  Narrow maps (7x7) take wider tiles so that the lanes of
    a CTA still find columns."""
    cq = c // 4
    best, best_busy = None, 0.0
    for quads in (8, 16, 32):
        lanes = DW_THREADS // quads
        cols = -(-w_out // lanes)
        if cols > 16:                        # the kernel's MAXC limit
            continue
        busy = cq * w_out / (-(-cq // quads) * quads * lanes * cols)
        if busy > best_busy:
            best, best_busy = quads, busy
    if best is None:
        raise ValueError(f"output width {w_out} > 256 is not supported")
    return best


def dw_smem_bytes(c: int, w_out: int, k_h: int, k_w: int, stride: int,
                  stream: bool, n_buffers: int) -> int:
    """Shared memory one CTA of the depthwise kernel claims (mirrors
    ``smem_bytes`` in ``csrc/dwconv_int8.cu``): the pinned taps or the
    ring, plus the k_h-row line buffer, of one channel tile."""
    quads = dw_quads(c, w_out)
    wp = (w_out - 1) * stride + k_w
    taps = k_h * k_w
    nb = min(n_buffers, taps) if stream else taps
    return (nb + k_h * wp) * quads * 4


def _outputs(x, w, w_scale, bias, shape, raw: bool, want_float: bool):
    """Check the operands of a launch and allocate its outputs:
    (int8, f32 or None, None) with the fused requant, else (None, None,
    int32)."""
    dev = x.device
    _build.check_cuda_tensor(x, "x", torch.int8, dev)
    _build.check_cuda_tensor(w, "w", torch.int8, dev)
    if raw:
        return None, None, torch.empty(shape, dtype=torch.int32, device=dev)
    _build.check_cuda_tensor(w_scale, "w_scale", torch.float32, dev)
    _build.check_cuda_tensor(bias, "bias", torch.float32, dev)
    if w_scale.numel() != shape[-1] or bias.numel() != shape[-1]:
        raise ValueError("w_scale and bias need C_out entries")
    out_f = (torch.empty(shape, dtype=torch.float32, device=dev)
             if want_float else None)
    return torch.empty(shape, dtype=torch.int8, device=dev), out_f, None


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


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
    shape = (B, h_out, w_out, c_out)
    out_q, out_f, out_i = _outputs(x, w, w_scale, bias, shape, raw,
                                   want_float)
    err = _lib("conv2d_int8").conv2d_int8_launch(
        _ptr(x), _ptr(w), _ptr(w_scale), _ptr(bias), act_scale,
        0.0 if raw else reciprocal(act_scale), _ptr(out_q),
        _ptr(out_f), _ptr(out_i), B, H, W, C, h_out, w_out, c_out, k_h, k_w,
        stride, pad_t, pad_l, int(stream), n_buffers, int(relu),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "conv2d_int8")
    _build.count_launch(KERNEL_STREAM if stream else KERNEL_PINNED)
    return out_i if raw else (out_q, out_f)


def _launch_dw(x, w, w_scale, bias, act_scale: float, *, stride: int,
               stream: bool, n_buffers: int, relu: bool, raw: bool,
               want_float: bool):
    B, H, W, C = x.shape
    k_h, k_w, w_one, w_c = w.shape
    if w_one != 1 or w_c != C:
        raise ValueError(f"depthwise weights {tuple(w.shape)} do not take "
                         f"C={C}")
    if C % 4:
        raise ValueError(f"C={C} must be a multiple of 4")
    if n_buffers < 1:
        raise ValueError("n_buffers must be >= 1")
    h_out, pad_t = same_out_and_pad(H, k_h, stride)
    w_out, pad_l = same_out_and_pad(W, k_w, stride)
    quads = dw_quads(C, w_out)
    smem = dw_smem_bytes(C, w_out, k_h, k_w, stride, stream, n_buffers)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"dwconv needs {smem} B of shared memory per "
                         f"block, more than {MAX_SMEM_BYTES}")
    dev = x.device
    out_q, out_f, out_i = _outputs(x, w, w_scale, bias, (B, h_out, w_out, C),
                                   raw, want_float)
    err = _lib("dwconv_int8").dwconv_int8_launch(
        _ptr(x), _ptr(w), _ptr(w_scale), _ptr(bias), act_scale,
        0.0 if raw else reciprocal(act_scale), _ptr(out_q), _ptr(out_f),
        _ptr(out_i), B, H, W, C, h_out, w_out, k_h, k_w, stride, pad_t,
        pad_l, quads, int(stream), n_buffers, int(relu),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dwconv_int8")
    _build.count_launch(KERNEL_DW_STREAM if stream else KERNEL_DW_PINNED)
    return out_i if raw else (out_q, out_f)


def conv2d_int8(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                stream: bool = False, n_buffers: int = 2,
                depthwise: bool = False) -> torch.Tensor:
    """SAME conv, int8 NHWC in / int32 out.  ``w`` is HWIO, or
    ``[k_h, k_w, 1, C]`` with ``depthwise=True``."""
    if _build.runs_plain(x):
        return conv2d_int8_ref(x, w, stride=stride, depthwise=depthwise)
    launch = _launch_dw if depthwise else _launch
    return launch(x, w, None, None, 0.0, stride=stride, stream=stream,
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
    launch = _launch_dw if depthwise else _launch
    return launch(x, w, w_scale, bias, act_scale, stride=stride,
                  stream=stream, n_buffers=n_buffers, relu=relu, raw=False,
                  want_float=want_float)
