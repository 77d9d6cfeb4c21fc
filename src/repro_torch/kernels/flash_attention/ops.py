"""Wrappers for the flash-attention forward (K9) and backward (K10, K11).

``flash_attention``         model layout: q ``[B,S,H,hd]``, k/v
                            ``[B,S,KV,hd]`` -> ``[B,S,H,hd_v]``
``flash_attention_kernel``  kernel layout: q ``[B,H,S,hd]``, k/v
                            ``[B,KV,S,hd]`` -> o (and ``lse [B,H,S]`` f32
                            with ``return_lse=True``, which the backward
                            needs)
``flash_attention_bwd``     kernel layout: dq, and dk/dv per query head
                            (K10 and K11, ``csrc/flash_attention_bwd.cu``)
``flash_attention_vjp``     model layout, differentiable: K9 forward,
                            K10/K11 backward and the GQA fold

A CPU tensor runs the plain version in ``ref.py`` at the JAX call's
blocks, ``min(128, S)`` (``flash_attention_plain`` takes other blocks
itself).  A CUDA tensor launches ``csrc/flash_attention.cu``
or raises: bf16, f16 or f32 operands, ``hd`` and ``hd_v`` each from 1 to
256.  The kernels take head dims that are multiples of 8
(:func:`head_dim_ok`: their 16-byte ``cp.async`` and TMA rows); a launch
at another head dim pads q, k, v (and the backward's do) with zero
columns to the next multiple of 8 (:func:`padded_dim`), keeps the scale
1/sqrt of the real head dim, and slices the outputs back: the zero
columns add nothing to a score, and the outputs' padded columns come
out zero.  :func:`flash_route` picks the forward kernel from (dtype,
hd, hd_v) alone, at the padded dims: a 16-bit pair with ``hd == hd_v``
in ``WGMMA_HEAD_DIMS`` runs on ``wgmma`` fed by TMA (128 query rows by
64 keys), the other 16-bit pairs on ``mma.sync`` (64 by 64), f32 on the
CUDA cores (64 by 32).  :func:`flash_bwd_route` picks the backward's the
same way: bf16 with ``hd == hd_v`` in ``WGMMA_HEAD_DIMS`` on ``wgmma``
fed by TMA (128 owned rows, tiles of 64), the other 16-bit pairs (f16
among them) on ``mma.sync``, f32 on the CUDA cores.  bf16 and f16 each
have their own instances of every 16-bit kernel.  The ``mma.sync`` forward and the 16-bit backward
are built at the widths ``KERNEL_HD`` x ``KERNEL_HD_V`` and run a head
dim at the narrowest that holds it (:func:`kernel_widths`), the columns
past it zero in shared memory.  Each reads the operands through their
strides, so the model layout goes in and out without a transposed copy
(but where it pads); the bases and strides must be 16-byte aligned (TMA
and ``cp.async`` need it).

Every launch charges its cost to the active cost counter
(``charge_fwd``, ``charge_bwd_dq``, ``charge_bwd_dkv``).  ``meta``
tensors take the launch path without launching: the outputs are
allocated on ``meta`` and the charge is made, so a dry run counts the
kernels as the card runs them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain, flash_attention_plain)

__all__ = ["flash_attention", "flash_attention_kernel",
           "flash_attention_bwd", "flash_attention_vjp", "KERNEL",
           "KERNEL_DQ", "KERNEL_DKV", "HEAD_DIM_STEP", "HEAD_DIM_MAX",
           "KERNEL_HD", "KERNEL_HD_V", "WGMMA_HEAD_DIMS", "head_dim_ok",
           "padded_dim", "kernel_widths", "flash_route", "flash_bwd_route",
           "bwd_wgmma_smem", "launch_shape"]

#: launch-counter names (replace ``_flash_kernel``, ``_flash_bwd_dq_kernel``
#: and ``_flash_bwd_dkv_kernel``)
KERNEL = "flash_attention_fwd"
KERNEL_DQ = "flash_attention_bwd_dq"
KERNEL_DKV = "flash_attention_bwd_dkv"
#: the head dims the kernels take: hd and hd_v each a multiple of
#: ``HEAD_DIM_STEP`` from ``HEAD_DIM_STEP`` to ``HEAD_DIM_MAX`` (a launch
#: at another head dim up to ``HEAD_DIM_MAX`` runs padded to one)
HEAD_DIM_STEP, HEAD_DIM_MAX = 8, 256
#: the widths (hd, hd_v) the 16-bit ``mma.sync`` forward and the 16-bit
#: backward are built at (``width()`` in ``csrc/mma_bf16.cuh``)
KERNEL_HD = (32, 64, 128, 192, 256)
KERNEL_HD_V = (32, 64, 128, 256)
#: head dims (hd = hd_v) of the 16-bit forward on wgmma and TMA
WGMMA_HEAD_DIMS = (64, 128)
#: the operand types, by the element code of the launch functions
_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
#: route codes of ``flash_attention_fwd_launch``
_ROUTES = {"mma_sync": 0, "f32": 1, "wgmma": 2}
#: route codes of ``flash_attention_bwd_launch``
_BWD_ROUTES = {"mma_sync": 0, "f32": 1, "wgmma": 2}
#: the backward's wgmma route: owned rows a CTA, rows of a streamed tile
#: and tiles in flight (``WG_OWN``, ``WG_TILE``, ``WG_STAGES`` in
#: ``csrc/flash_attention_bwd.cu``); lse and delta go in with their rows
#: padded to a multiple of the tile
BWD_WGMMA_OWN, BWD_WGMMA_TILE, BWD_WGMMA_STAGES = 128, 64, 2
#: dtype codes of ``flash_attention_bwd_launch``, by (operands' dtype,
#: f32 grads): the grads in the operands' dtype, or the f32 sums of the
#: 16-bit kernels before their rounding
_BWD_DTYPES = {(torch.bfloat16, False): 0, (torch.float32, False): 1,
               (torch.bfloat16, True): 2, (torch.float16, False): 3,
               (torch.float16, True): 4}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_Strides = ctypes.c_longlong * 12
_BwdStrides = ctypes.c_longlong * 21


def _lib(dtype) -> ctypes.CDLL:
    """The forward's library for operands of ``dtype``: f16's instances
    are built apart (``_build.VARIANTS``)."""
    lib = _build.load("flash_attention_f16" if dtype == torch.float16
                      else "flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd_launch.argtypes = \
            [_P] * 5 + [_I] * 9 + [_Strides, _I, _I, _F, _F, _P]
        lib.flash_attention_fwd_launch.restype = _I
        lib._typed = True
    return lib


def _bwd_lib(dtype) -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd_f16" if dtype == torch.float16
                      else "flash_attention_bwd")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_bwd_launch.argtypes = \
            [_P] * 9 + [_I] * 10 + [_BwdStrides, _I, _I, _F, _F, _P]
        lib.flash_attention_bwd_launch.restype = _I
        lib.flash_attention_bwd_wgmma_smem.argtypes = [_I, _I]
        lib.flash_attention_bwd_wgmma_smem.restype = _I
        lib._typed = True
    return lib


def head_dim_ok(d: int) -> bool:
    """Whether the kernels take a head dim of ``d`` as it is: a multiple
    of ``HEAD_DIM_STEP`` from ``HEAD_DIM_STEP`` to ``HEAD_DIM_MAX``."""
    return d % HEAD_DIM_STEP == 0 and HEAD_DIM_STEP <= d <= HEAD_DIM_MAX


def padded_dim(d: int) -> int:
    """The head dim a launch at ``d`` runs at: ``d`` rounded up to a
    multiple of ``HEAD_DIM_STEP``.  Raises ``ValueError`` outside 1 to
    ``HEAD_DIM_MAX``."""
    if not 1 <= d <= HEAD_DIM_MAX:
        raise ValueError(f"head dim {d} not supported by the CUDA kernels: "
                         f"each of hd and hd_v must be from 1 to "
                         f"{HEAD_DIM_MAX}")
    return -(-d // HEAD_DIM_STEP) * HEAD_DIM_STEP


def kernel_widths(hd: int, hd_v: int) -> tuple:
    """The widths ``(HD, HDV)`` of the 16-bit kernels a launch at head
    dims ``(hd, hd_v)`` (as the kernels take them: multiples of 8) runs
    at (``flash_fwd_16<HD, HDV>`` on the ``mma.sync`` route,
    ``flash_bwd_*_tc<HD, HDV>``): the narrowest of ``KERNEL_HD`` and
    ``KERNEL_HD_V`` that hold them."""
    if not (head_dim_ok(hd) and head_dim_ok(hd_v)):
        raise ValueError(_refusal(hd, hd_v))
    return (next(w for w in KERNEL_HD if hd <= w),
            next(w for w in KERNEL_HD_V if hd_v <= w))


def _refusal(hd: int, hd_v: int) -> str:
    return (f"head dims (hd={hd}, hd_v={hd_v}) not taken by the CUDA "
            f"kernels as they are: each must be a multiple of "
            f"{HEAD_DIM_STEP} from {HEAD_DIM_STEP} to {HEAD_DIM_MAX} "
            f"(a launch pads other head dims up to {HEAD_DIM_MAX})")


def flash_route(dtype, hd: int, hd_v: int) -> str:
    """The forward kernel a launch with operands of ``dtype`` and head dims
    ``(hd, hd_v)`` takes, from those alone, at the padded dims
    (``flash_attention_fwd_launch`` in ``csrc/flash_attention.cu``
    refuses any other): ``"wgmma"`` for bf16 or f16 with ``hd == hd_v``
    in ``WGMMA_HEAD_DIMS``, ``"mma_sync"`` for the other 16-bit pairs,
    ``"f32"`` for f32.  Raises ``TypeError`` for another dtype (f64, say)
    and ``ValueError`` for a head dim outside 1 to 256 (264, say): nothing
    takes another path."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash attention takes bf16, f16 or f32, not "
                        f"{dtype}")
    if not (1 <= hd <= HEAD_DIM_MAX and 1 <= hd_v <= HEAD_DIM_MAX):
        raise ValueError(f"head dims (hd={hd}, hd_v={hd_v}) not supported "
                         f"by the CUDA kernels: each must be from 1 to "
                         f"{HEAD_DIM_MAX}")
    if dtype == torch.float32:
        return "f32"
    hd, hd_v = padded_dim(hd), padded_dim(hd_v)
    return "wgmma" if hd == hd_v and hd in WGMMA_HEAD_DIMS else "mma_sync"


def flash_bwd_route(dtype, hd: int, hd_v: int) -> str:
    """The backward kernels (K10 and K11) a launch with operands of
    ``dtype`` and head dims ``(hd, hd_v)`` takes, from those alone, at the
    padded dims (``flash_attention_bwd_launch`` refuses a route that does
    not take the launch): ``"wgmma"`` for bf16 with ``hd == hd_v`` in
    ``WGMMA_HEAD_DIMS``, ``"mma_sync"`` for the other 16-bit pairs (f16
    at every head dim: its accumulating products run on tf32, whose
    ``wgmma`` wants K-major B), ``"f32"`` for f32.  Raises as
    :func:`flash_route` does."""
    route = flash_route(dtype, hd, hd_v)
    if route == "wgmma" and dtype != torch.bfloat16:
        return "mma_sync"
    return route


def bwd_wgmma_smem(which: int, hd: int) -> int:
    """The dynamic shared memory a launch of the backward's ``wgmma``
    route asks for (``which`` 0: K10, dq; 1: K11, dk and dv) at ``hd =
    hd_v`` in ``WGMMA_HEAD_DIMS``: the two owned operands of
    ``BWD_WGMMA_OWN`` rows, ``BWD_WGMMA_STAGES`` stages of the two
    streamed ones of ``BWD_WGMMA_TILE`` rows (and K11's lse and delta of
    the tile in a 1024-byte slot), and 1024 bytes to align the base
    (``BwdLayout`` in ``csrc/flash_attention_bwd.cu``, which
    ``flash_attention_bwd_wgmma_smem`` reports)."""
    if hd not in WGMMA_HEAD_DIMS or which not in (0, 1):
        raise ValueError(f"no wgmma backward at hd={hd}, which={which}")
    row = 2 * hd                                 # bytes of one bf16 row
    stage = 2 * BWD_WGMMA_TILE * row + (1024 if which else 0)
    return 2 * BWD_WGMMA_OWN * row + BWD_WGMMA_STAGES * stage + 1024


def launch_shape(dtype, B: int, H: int, KV: int, Sq: int, Sk: int, hd: int,
                 hd_v: int, causal: bool, window: int,
                 softcap: float) -> tuple:
    """A launch's key in ``_build.SHAPE_LAUNCHES`` (under ``KERNEL``,
    ``KERNEL_DQ`` or ``KERNEL_DKV``):
    ``("bfloat16", "float16" or "float32", B, H, KV, Sq, Sk, hd, hd_v,
    causal, window, softcap)``, at the real head dims."""
    return (str(dtype).removeprefix("torch."), B, H, KV, Sq, Sk, hd, hd_v,
            bool(causal), int(window), float(softcap))


def kernel_strides(t: torch.Tensor) -> tuple:
    """``t``'s strides as the kernels are given them: a size-1 dim's stride
    is never read, but TMA wants every stride aligned, so it becomes the
    span of the other dims (an autograd gradient of batch 1 may come with
    stride 1 there)."""
    span = max((n * s for n, s in zip(t.shape, t.stride()) if n > 1),
               default=1)
    return tuple(span if n == 1 else s for n, s in zip(t.shape, t.stride()))


def _flash_blocks(Sq: int, Sk: int):
    """The JAX call's blocks: ``min(128, S)``."""
    bq, bk = min(128, Sq), min(128, Sk)
    return bq, bk, -(-Sq // bq), -(-Sk // bk)


def charge_fwd(B: int, H: int, KV: int, Sq: int, Sk: int, hd: int, hd_v: int,
              elem_bytes: int, *, causal: bool, window: int,
              softcap: float) -> _build.Charge:
    """K9's charge (``_build.Charge``): q [B,H,Sq,hd], k [B,KV,Sk,hd], v
    [B,KV,Sk,hd_v] -> o [B,H,Sq,hd_v] and lse [B,H,Sq] f32."""
    bq, bk, nq, nk = _flash_blocks(Sq, Sk)
    f32 = elem_bytes == 4
    dots = 2 * bq * bk * (hd + hd_v)
    body = (dots
            + (13 + 2 * bool(causal) + 3 * bool(window) + 3 * bool(softcap)
               - f32) * bq * bk
            + bq * hd + bk * hd + bk * hd_v + (10 - f32) * bq * hd_v
            + 25 * bq + 10)
    grid = B * H * nq * nk
    nbytes = (elem_bytes * (B * H * Sq * hd + B * KV * Sk * (hd + hd_v)
                            + B * H * Sq * hd_v) + 4 * B * H * Sq)
    return _build.Charge(body * grid, nbytes, dots * grid)


def _flash_bwd_common(Sq, Sk, causal, window, softcap):
    bq, bk, nq, nk = _flash_blocks(Sq, Sk)
    per_tile = (14 + 2 * bool(causal) + 3 * bool(window)
                + 7 * bool(softcap)) * bq * bk + 4 * bq + 10
    return bq, bk, nq, nk, per_tile


def _flash_bwd_in_bytes(B, H, KV, Sq, Sk, hd, hd_v, elem_bytes):
    """q, k, v (at KV heads), do, lse and delta."""
    return (elem_bytes * (B * H * Sq * hd + B * KV * Sk * (hd + hd_v)
                          + B * H * Sq * hd_v) + 8 * B * H * Sq)


def charge_bwd_dq(B: int, H: int, KV: int, Sq: int, Sk: int, hd: int,
                 hd_v: int, elem_bytes: int, out_bytes: int, *, causal: bool,
                 window: int, softcap: float) -> _build.Charge:
    """K10's charge: dq [B,H,Sq,hd] from q, k, v, do, lse, delta.  K10
    and K11 read k and v at their ``KV`` heads (the JAX wrapper hands its
    kernels k and v repeated to ``H`` heads), and the charge counts the
    bytes the port's launch reads."""
    bq, bk, nq, nk, per_tile = _flash_bwd_common(Sq, Sk, causal, window,
                                                 softcap)
    c = 1 if elem_bytes == 4 else 2           # a load and its f32 cast
    dots = 2 * bq * bk * (2 * hd + hd_v)
    body = (dots + per_tile + (7 + 2 * c) * bq * hd + c * bq * hd_v
            + c * bk * hd + c * bk * hd_v)
    grid = B * H * nq * nk
    nbytes = (_flash_bwd_in_bytes(B, H, KV, Sq, Sk, hd, hd_v, elem_bytes)
              + out_bytes * B * H * Sq * hd)
    return _build.Charge(body * grid, nbytes, dots * grid)


def charge_bwd_dkv(B: int, H: int, KV: int, Sq: int, Sk: int, hd: int,
                  hd_v: int, elem_bytes: int, out_bytes: int, *,
                  causal: bool, window: int, softcap: float) -> _build.Charge:
    """K11's charge: dk [B,H,Sk,hd] and dv [B,H,Sk,hd_v] (per query
    head)."""
    bq, bk, nq, nk, per_tile = _flash_bwd_common(Sq, Sk, causal, window,
                                                 softcap)
    c = 1 if elem_bytes == 4 else 2
    dots = 2 * bq * bk * (2 * hd + 2 * hd_v)
    body = (dots + per_tile + c * bq * hd + c * bq * hd_v
            + (7 + 2 * c) * bk * hd + (6 + 2 * c) * bk * hd_v)
    grid = B * H * nq * nk
    nbytes = (_flash_bwd_in_bytes(B, H, KV, Sq, Sk, hd, hd_v, elem_bytes)
              + out_bytes * B * H * Sk * (hd + hd_v))
    return _build.Charge(body * grid, nbytes, dots * grid)


def _check_type(t: torch.Tensor, name: str, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")


def _check(t: torch.Tensor, name: str, dtype, device) -> None:
    """What a kernel asks of an operand or output it is handed: its
    device and dtype, the head dim contiguous, the base and strides
    16-byte aligned."""
    _check_type(t, name, dtype, device)
    align = 16 // t.element_size()
    strides = kernel_strides(t)
    if strides[3] != 1 or any(s % align for s in strides[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: the head dim must be contiguous, and the "
                         f"base and strides 16-byte aligned for the TMA and "
                         f"cp.async copies (strides {t.stride()}, base "
                         f"{t.data_ptr() % 16} bytes past 16)")


def _check_shapes(q, k, v) -> str:
    """Check the shapes and return the forward's route."""
    B, H, _, hd = q.shape
    KV, Sk, hd_v = k.shape[1], k.shape[2], v.shape[3]
    route = flash_route(q.dtype, hd, hd_v)
    if H % KV or tuple(v.shape[:3]) != (B, KV, Sk) or k.shape[0] != B \
            or k.shape[3] != hd:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    return route


def _pad(t: torch.Tensor, d: int) -> torch.Tensor:
    """``t`` with zero columns past its last dim up to ``d`` (a copy in
    ``t``'s dim order, its last dim contiguous), or ``t`` itself."""
    if t.shape[-1] == d:
        return t
    return torch.nn.functional.pad(t, (0, d - t.shape[-1]))


def _launch(q, k, v, o, lse, *, causal: bool, window: int,
            softcap: float) -> None:
    """q/k/v/o as ``[B, heads, S, dim]`` views (any strides the checks
    accept); lse contiguous ``[B,H,Sq]``.  Head dims that are not a
    multiple of 8 run padded (q, k and v copied with zero columns; o
    written through a padded buffer)."""
    B, H, Sq, hd = q.shape
    KV, Sk, hd_v = k.shape[1], k.shape[2], v.shape[3]
    route = _check_shapes(q, k, v)
    dev = q.device
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o")):
        _check_type(t, name, q.dtype, dev)
    cost = charge_fwd(B, H, KV, Sq, Sk, hd, hd_v, q.element_size(),
                      causal=causal, window=window, softcap=softcap)
    if dev.type == "meta":
        _build.charge(cost)
        return
    pd, pdv = padded_dim(hd), padded_dim(hd_v)
    qp, kp, vp = _pad(q, pd), _pad(k, pd), _pad(v, pdv)
    op = o if pdv == hd_v else torch.empty((B, H, Sq, pdv), dtype=o.dtype,
                                           device=dev)
    for t, name in ((qp, "q"), (kp, "k"), (vp, "v"), (op, "o")):
        _check(t, name, q.dtype, dev)
    strides = _Strides(*(s for t in (qp, kp, vp, op)
                         for s in kernel_strides(t)[:3]))
    err = _lib(q.dtype).flash_attention_fwd_launch(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), op.data_ptr(),
        lse.data_ptr(), _ROUTES[route], _DTYPES[q.dtype], B, H, KV, Sq, Sk,
        pd, pdv, strides, int(causal), int(window), float(softcap),
        1.0 / math.sqrt(hd), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_attention")
    _build.count_launch(KERNEL, launch_shape(q.dtype, B, H, KV, Sq, Sk, hd,
                                             hd_v, causal, window, softcap),
                        cost)
    if op is not o:
        o.copy_(op[..., :hd_v])


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0, softcap: float = 0.0,
                           return_lse: bool = False):
    """q: [B,H,Sq,hd]; k: [B,KV,Sk,hd]; v: [B,KV,Sk,hd_v] -> o
    [B,H,Sq,hd_v] in q's dtype (and lse [B,H,Sq] f32 if requested)."""
    if _build.runs_plain(q, meta_launches=True):
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
                    softcap: float = 0.0, return_lse: bool = False):
    """q: [B,Sq,H,hd]; k/v: [B,Sk,KV,hd] -> [B,Sq,H,hd_v] (model
    layout), and lse [B,H,Sq] f32 if requested."""
    if _build.runs_plain(q, meta_launches=True):
        o, lse = flash_attention_kernel(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, softcap=softcap, return_lse=True)
        o = o.transpose(1, 2)
    else:
        B, Sq, H, _ = q.shape
        o = torch.empty((B, Sq, H, v.shape[3]), dtype=q.dtype,
                        device=q.device)
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        _launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                o.transpose(1, 2), lse, causal=causal, window=window,
                softcap=softcap)
    return (o, lse) if return_lse else o


def _launch_bwd(q, k, v, do, lse, delta, dq, dk, dv, *, causal: bool,
                window: int, softcap: float, which=(0, 1),
                route=None) -> None:
    """K10 (``which`` 0) then K11 (1).  q/k/v/do/dq/dk/dv as ``[B, heads,
    S, dim]`` views (any strides the checks accept; dk/dv per query head);
    lse and delta contiguous ``[B,H,Sq]`` f32.  The grads take q's dtype,
    or f32 beside 16-bit operands (the f32 sums).  ``which`` picks one of
    the two for timing each alone; ``route`` the kernels (by default
    :func:`flash_bwd_route`'s; ``"mma_sync"`` runs a 16-bit launch that
    route would send to ``wgmma`` on the earlier kernels, to hold the two
    against each other).  Head dims that are not a multiple of 8 run
    padded: q, k, v and do copied with zero columns, the grads written
    through padded buffers (whose padded columns come out zero) and
    copied back.  The ``wgmma`` route takes lse and delta with their rows
    padded to a multiple of ``BWD_WGMMA_TILE`` (copied here)."""
    B, H, Sq, hd = q.shape
    KV, Sk, hd_v = k.shape[1], k.shape[2], v.shape[3]
    _check_shapes(q, k, v)
    if tuple(do.shape) != (B, H, Sq, hd_v):
        raise ValueError(f"do {tuple(do.shape)} != {(B, H, Sq, hd_v)}")
    own = flash_bwd_route(q.dtype, hd, hd_v)
    route = route or own
    if route != own and not (route == "mma_sync" and own == "wgmma"):
        raise ValueError(f"the {route} route does not take {q.dtype} "
                         f"operands at head dims ({hd}, {hd_v}): "
                         f"{own} does")
    dev = q.device
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (do, "do")):
        _check_type(t, name, q.dtype, dev)
    # 16-bit operands with f32 grads: the sums before their rounding
    f32_sums = q.dtype != torch.float32 and dq.dtype == torch.float32
    dtype = _BWD_DTYPES[q.dtype, f32_sums]
    grad_dtype = torch.float32 if f32_sums else q.dtype
    for t, name in ((dq, "dq"), (dk, "dk"), (dv, "dv")):
        _check_type(t, name, grad_dtype, dev)
    for t, name in ((lse, "lse"), (delta, "delta")):
        _build.check_cuda_tensor(t, name, torch.float32, dev)
    charges = tuple(
        fn(B, H, KV, Sq, Sk, hd, hd_v, q.element_size(), dq.element_size(),
           causal=causal, window=window, softcap=softcap)
        for fn in (charge_bwd_dq, charge_bwd_dkv))
    if dev.type == "meta":
        for kernel in which:
            _build.charge(charges[kernel])
        return
    pd, pdv = padded_dim(hd), padded_dim(hd_v)
    ins = (_pad(q, pd), _pad(k, pd), _pad(v, pdv), _pad(do, pdv))
    outs = tuple(g if g.shape[-1] == d else torch.empty(
        g.shape[:-1] + (d,), dtype=g.dtype, device=dev)
        for g, d in ((dq, pd), (dk, pd), (dv, pdv)))
    for t, name in zip(ins, ("q", "k", "v", "do")):
        _check(t, name, q.dtype, dev)
    for t, name in zip(outs, ("dq", "dk", "dv")):
        _check(t, name, grad_dtype, dev)
    if route == "wgmma":
        lse, delta = (_pad_rows(t, BWD_WGMMA_TILE) for t in (lse, delta))
    strides = _BwdStrides(*(s for t in ins + outs
                            for s in kernel_strides(t)[:3]))
    lib = _bwd_lib(q.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for kernel in which:
        name = (KERNEL_DQ, KERNEL_DKV)[kernel]
        err = lib.flash_attention_bwd_launch(
            *(t.data_ptr() for t in ins), lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outs), kernel, dtype,
            _BWD_ROUTES[route], B, H, KV, Sq, Sk, pd, pdv, strides,
            int(causal), int(window), float(softcap), 1.0 / math.sqrt(hd),
            stream)
        _build.check(err, name)
        _build.count_launch(name, launch_shape(q.dtype, B, H, KV, Sq, Sk, hd,
                                               hd_v, causal, window, softcap),
                            charges[kernel])
    for g, pg in zip((dq, dk, dv), outs):
        if pg is not g:
            g.copy_(pg[..., :g.shape[-1]])


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """A contiguous ``[B, H, S]`` f32 tensor as ``[B, H, Sp]`` with ``Sp``
    the next multiple of ``n``, zeros past ``S`` (``t`` itself where ``S``
    is one)."""
    pad = -t.shape[-1] % n
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(do * o) in f32, ``[B,H,Sq]`` contiguous, from kernel-layout
    views: what the JAX wrapper computes outside its kernels."""
    return (do.float() * o.float()).sum(-1).contiguous()


def _empty_in_layout_of(ref: torch.Tensor, shape, dtype) -> torch.Tensor:
    """An empty ``[B, heads, S, d]`` tensor whose heads and seq axes lie in
    memory in ``ref``'s order: a transposed view of ``[B, S, heads, d]``
    when ``ref`` is such a view (the model layout)."""
    B, heads, S, d = shape
    if ref.stride(1) < ref.stride(2):
        return torch.empty((B, S, heads, d), dtype=dtype,
                           device=ref.device).transpose(1, 2)
    return torch.empty(shape, dtype=dtype, device=ref.device)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        out_dtype=None, route=None):
    """Kernel layout: q ``[B,H,Sq,hd]``, k ``[B,KV,Sk,hd]``, v
    ``[B,KV,Sk,hd_v]``, o and do ``[B,H,Sq,hd_v]``, lse ``[B,H,Sq]`` f32
    -> ``(dq [B,H,Sq,hd], dk [B,H,Sk,hd], dv [B,H,Sk,hd_v])``, dk and dv
    per query head (the GQA fold is the caller's), each in its operand's
    dtype.  ``out_dtype=torch.float32`` with bf16 or f16 operands gives
    the f32 sums before their rounding: a check that sees below the
    16-bit type's precision (the JAX wrapper has no such option).
    CPU tensors run ``flash_attention_bwd_plain`` at the JAX call's
    blocks; CUDA tensors launch K10 and K11 or raise, writing the grads in
    q's layout (views of the model layout for model-layout q), on the
    kernels of :func:`flash_bwd_route`, or of ``route="mma_sync"`` where
    that is ``"wgmma"`` (the earlier kernels, for holding the two routes
    against each other; the JAX wrapper has no such option either)."""
    if out_dtype not in (None, q.dtype) and (
            q.dtype not in (torch.bfloat16, torch.float16)
            or out_dtype != torch.float32):
        raise TypeError(f"grads in {out_dtype} from {q.dtype} operands: "
                        f"only bf16 or f16 operands give f32 grads")
    if _build.runs_plain(q, meta_launches=True):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, softcap=softcap,
                                         out_dtype=out_dtype)
    B, H, Sq, hd = q.shape
    Sk, hd_v = k.shape[2], v.shape[3]
    dq = _empty_in_layout_of(q, (B, H, Sq, hd), out_dtype or q.dtype)
    dk = _empty_in_layout_of(q, (B, H, Sk, hd), out_dtype or k.dtype)
    dv = _empty_in_layout_of(q, (B, H, Sk, hd_v), out_dtype or v.dtype)
    _launch_bwd(q, k, v, do, lse.contiguous(), _delta(o, do), dq, dk, dv,
                causal=causal, window=window, softcap=softcap, route=route)
    return dq, dk, dv


def _fold(g: torch.Tensor, KV: int, dtype) -> torch.Tensor:
    """Per-query-head grads ``[B,S,H,d]`` -> ``[B,S,KV,d]``: each group's
    heads summed in f32 and rounded once, as the JAX package's bf16 sum
    on the CPU does."""
    B, S, H, d = g.shape
    if H == KV:
        return g.to(dtype)
    return g.reshape(B, S, KV, H // KV, d).float().sum(3).to(dtype)


class flash_attention_vjp(torch.autograd.Function):
    """Differentiable flash attention in model layout: q ``[B,S,H,hd]``,
    k ``[B,S,KV,hd]``, v ``[B,S,KV,hd_v]`` -> ``[B,S,H,hd_v]``.  The
    forward is K9 with the lse kept for the backward; the backward is K10
    and K11 (dk and dv per query head), then the GQA fold of the JAX
    wrapper's ``_bwd_rule``.  CPU tensors run the plain versions.

    ``flash_attention_vjp.apply(q, k, v, causal, window, softcap)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, softcap)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        qt, kt, vt, ot, gt = (t.transpose(1, 2)
                              for t in (q, k, v, o, g.contiguous()))
        grads = flash_attention_bwd(qt, kt, vt, ot, lse, gt, causal=causal,
                                    window=window, softcap=softcap)
        dq, dk, dv = (t.transpose(1, 2) for t in grads)
        KV = k.shape[2]
        return (dq, _fold(dk, KV, k.dtype), _fold(dv, KV, v.dtype), None,
                None, None)
