"""Wrappers for the streamed-weight matmul.

``stream_matmul(x, w, mode=...)``:
  mode="stream"  W's K-blocks stream through a ring of depth 2
  mode="fifo"    an explicit n_buffers-deep ring (credit semantics)
  mode="pinned"  one K block spanning all of K: the whole W slice is
                 resident for the call (on-chip tier)

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
``csrc/stream_matmul.cu`` (int8 operands only) or raises.  ``bm``/``bn``
are the JAX kernel's block sizes and only feed :func:`vmem_bytes`
accounting (``vmem_bytes``); the CUDA kernel picks its own tiles and masks
ragged edges.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_int8.ops import MAX_SMEM_BYTES
from repro_torch.kernels.quant import reciprocal, requant_epilogue
from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref

__all__ = ["stream_matmul", "stream_matmul_requant", "vmem_bytes",
           "KERNELS"]

#: launch-counter name per mode ("pinned"/"stream" replace _mm_kernel,
#: "fifo" replaces _mm_manual_kernel)
KERNELS = {m: f"stream_matmul_{m}" for m in ("pinned", "stream", "fifo")}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("stream_matmul")
    if not getattr(lib, "_typed", False):
        lib.stream_matmul_int8_launch.argtypes = \
            [_P, _P, _P, _P, _F, _F, _P, _P, _P] + [_I] * 6 + [_P]
        lib.stream_matmul_int8_launch.restype = _I
        lib._typed = True
    return lib


def ring(mode: str, K: int, bk: int, n_buffers: int) -> Tuple[int, int]:
    """(K-block rows, ring depth) the kernel runs ``mode`` with."""
    if mode == "pinned":
        return K, 1
    if mode == "stream":
        return min(bk, K), 2
    if mode == "fifo":
        return min(bk, K), n_buffers
    raise ValueError(f"unknown mode {mode!r}")


def smem_bytes(K: int, bk: int, n_buffers: int) -> int:
    """Shared memory one CTA claims (mirrors ``smem_bytes`` in
    ``csrc/stream_matmul.cu``)."""
    nk = -(-K // bk)
    return (8 * K + 3) // 4 * 4 + min(n_buffers, nk) * bk * 32


def _launch(x, w, w_scale, bias, act_scale: float, *, mode: str, bk: int,
            n_buffers: int, relu: bool, raw: bool, want_float: bool):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise NotImplementedError(
            "the CUDA matmul takes int8 operands; float modes run on the CPU")
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    blk, nb = ring(mode, K, bk, n_buffers)
    if nb < 1:
        raise ValueError("n_buffers must be >= 1")
    smem = smem_bytes(K, blk, nb)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"matmul needs {smem} B of shared memory per "
                         f"block, more than {MAX_SMEM_BYTES}")
    dev = x.device
    _build.check_cuda_tensor(x, "x", torch.int8, dev)
    _build.check_cuda_tensor(w, "w", torch.int8, dev)
    out_q = out_f = out_i = None
    if raw:
        out_i = torch.empty((M, N), dtype=torch.int32, device=dev)
    else:
        _build.check_cuda_tensor(w_scale, "w_scale", torch.float32, dev)
        _build.check_cuda_tensor(bias, "bias", torch.float32, dev)
        if w_scale.numel() != N or bias.numel() != N:
            raise ValueError("w_scale and bias need N entries")
        out_q = torch.empty((M, N), dtype=torch.int8, device=dev)
        if want_float:
            out_f = torch.empty((M, N), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _lib().stream_matmul_int8_launch(
        ptr(x), ptr(w), ptr(w_scale), ptr(bias), act_scale,
        0.0 if raw else reciprocal(act_scale), ptr(out_q),
        ptr(out_f), ptr(out_i), M, K, N, blk, nb, int(relu),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "stream_matmul")
    _build.count_launch(KERNELS[mode])
    return out_i if raw else (out_q, out_f)


def stream_matmul(x: torch.Tensor, w: torch.Tensor, *, mode: str = "stream",
                  bk: int = 512, n_buffers: int = 2) -> torch.Tensor:
    """x: [M, K] @ w: [K, N] -> int32 (int8 operands) or float32."""
    ring(mode, w.shape[0], bk, n_buffers)            # validates the mode
    if _build.runs_plain(x):
        return stream_matmul_ref(x, w)
    return _launch(x, w, None, None, 0.0, mode=mode, bk=bk,
                   n_buffers=n_buffers, relu=False, raw=True,
                   want_float=False)


def stream_matmul_requant(x: torch.Tensor, w: torch.Tensor,
                          w_scale: torch.Tensor, bias: torch.Tensor,
                          act_scale: float = 0.05, *, relu: bool = True,
                          mode: str = "stream", bk: int = 512,
                          n_buffers: int = 2, want_float: bool = True
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """int8 matmul + the requant epilogue: (int8 [M, N], f32 pre-quant
    [M, N] or None)."""
    ring(mode, w.shape[0], bk, n_buffers)
    if _build.runs_plain(x):
        y_q, y_f = requant_epilogue(stream_matmul_ref(x, w), w_scale, bias,
                                    act_scale=act_scale, relu=relu)
        return y_q, (y_f if want_float else None)
    return _launch(x, w, w_scale, bias, act_scale, mode=mode, bk=bk,
                   n_buffers=n_buffers, relu=relu, raw=False,
                   want_float=want_float)


def vmem_bytes(mode: str, M: int, K: int, N: int, dtype_bytes: int, *,
               bm: int = 128, bk: int = 512, bn: int = 128,
               n_buffers: int = 2) -> int:
    """Working set the JAX kernel's call claims — the M20K-cost analogue
    the placement planner charges per decision (Eq. 1's '-2' term).  Kept
    equal to the JAX package's so both compile to the same tables."""
    bm, bk, bn = min(bm, M), min(bk, K), min(bn, N)
    x_b = bm * (K if mode == "fifo" else bk) * dtype_bytes
    if mode == "pinned":
        w_b = K * bn * dtype_bytes
    elif mode == "fifo":
        w_b = n_buffers * bk * bn * dtype_bytes
    else:
        w_b = 2 * bk * bn * dtype_bytes          # double buffer
    o_b = bm * bn * 4
    return x_b + w_b + o_b
