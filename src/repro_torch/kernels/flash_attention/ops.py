"""Wrappers for the flash-attention forward (K9).

``flash_attention``         model layout: q ``[B,S,H,hd]``, k/v
                            ``[B,S,KV,hd]`` -> ``[B,S,H,hd_v]``
``flash_attention_kernel``  kernel layout: q ``[B,H,S,hd]``, k/v
                            ``[B,KV,S,hd]`` -> o (and ``lse [B,H,S]`` f32
                            with ``return_lse=True``, which the backward
                            needs)

A CPU tensor runs the plain version in ``ref.py`` at the JAX call's
blocks, ``min(128, S)`` (``flash_attention_plain`` takes other blocks
itself).  A CUDA tensor launches ``csrc/flash_attention.cu``
or raises: bf16 or f32 operands, ``hd`` in {32, 64, 128, 192, 256} and
``hd_v`` in {32, 64, 128, 256}.  The CUDA kernel picks its own blocks
(bf16: 64 query rows by 64 keys; f32: 64 by 32) and reads the operands
through their strides, so the model layout goes in and out without a
transposed copy.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

__all__ = ["flash_attention", "flash_attention_kernel", "KERNEL",
           "HEAD_DIMS", "HEAD_DIMS_V"]

#: launch-counter name (replaces ``_flash_kernel``)
KERNEL = "flash_attention_fwd"
HEAD_DIMS = (32, 64, 128, 192, 256)
HEAD_DIMS_V = (32, 64, 128, 256)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_Strides = ctypes.c_longlong * 12


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd_launch.argtypes = \
            [_P] * 5 + [_I] * 8 + [_Strides, _I, _I, _F, _F, _P]
        lib.flash_attention_fwd_launch.restype = _I
        lib._typed = True
    return lib


def _check(t: torch.Tensor, name: str, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    align = 16 // t.element_size()
    if t.stride(3) != 1 or any(s % align for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: the head dim must be contiguous and rows "
                         f"16-byte aligned (strides {t.stride()})")


def _launch(q, k, v, o, lse, *, causal: bool, window: int,
            softcap: float) -> None:
    """q/k/v/o as ``[B, heads, S, dim]`` views (any strides the checks
    accept); lse contiguous ``[B,H,Sq]``."""
    B, H, Sq, hd = q.shape
    KV, Sk, hd_v = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes bf16 or f32, not {q.dtype}")
    if hd not in HEAD_DIMS or hd_v not in HEAD_DIMS_V:
        raise ValueError(f"head dims (hd={hd}, hd_v={hd_v}) not supported "
                         f"by the CUDA kernel: hd in {HEAD_DIMS}, hd_v in "
                         f"{HEAD_DIMS_V}")
    if H % KV or tuple(v.shape[:3]) != (B, KV, Sk) or k.shape[0] != B \
            or k.shape[3] != hd:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    dev = q.device
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o")):
        _check(t, name, q.dtype, dev)
    strides = _Strides(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
    err = _lib().flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _DTYPES[q.dtype], B, H, KV, Sq, Sk, hd, hd_v,
        strides, int(causal), int(window), float(softcap),
        1.0 / math.sqrt(hd), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_attention")
    _build.count_launch(KERNEL)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0, softcap: float = 0.0,
                           return_lse: bool = False):
    """q: [B,H,Sq,hd]; k: [B,KV,Sk,hd]; v: [B,KV,Sk,hd_v] -> o
    [B,H,Sq,hd_v] in q's dtype (and lse [B,H,Sq] f32 if requested)."""
    if _build.runs_plain(q):
        o, lse = flash_attention_plain(q, k, v, causal=causal,
                                       window=window, softcap=softcap)
    else:
        B, H, Sq, _ = q.shape
        o = torch.empty((B, H, Sq, v.shape[3]), dtype=q.dtype,
                        device=q.device)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        _launch(q, k, v, o, lse, causal=causal, window=window,
                softcap=softcap)
    return (o, lse) if return_lse else o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k/v: [B,Sk,KV,hd] -> [B,Sq,H,hd_v] (model
    layout)."""
    if _build.runs_plain(q):
        o = flash_attention_kernel(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, softcap=softcap)
        return o.transpose(1, 2)
    B, Sq, H, _ = q.shape
    o = torch.empty((B, Sq, H, v.shape[3]), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            o.transpose(1, 2), lse, causal=causal, window=window,
            softcap=softcap)
    return o
