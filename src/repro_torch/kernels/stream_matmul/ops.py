"""Wrappers for the streamed-weight matmul.

``stream_matmul(x, w, mode=...)``:
  mode="stream"  W's K-blocks stream through a ring of depth 2
  mode="fifo"    an explicit n_buffers-deep ring (credit semantics)
  mode="pinned"  one K block spanning all of K: the whole W slice is
                 resident for the call (on-chip tier)

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
``csrc/stream_matmul.cu`` or raises: int8 operands ``mm_kernel`` with the
launch plan of :func:`mm_plan`; every other pair over f32, bf16, f16 and
int8 the float modes with the plan of :func:`mm_float_plan` (the result
in the promoted type, ``ref.result_dtype``): ``mm_float_tc`` on the
tensor cores where the weights are bf16, f16 or int8
(:func:`mm_float_tensor_cores`; an f32 x split exactly into three bf16
parts), ``mm_float`` (FFMA) where they are f32; any other operand type
(f64, say) raises ``NotImplementedError``.  ``bm``/``bn`` are the JAX kernel's
block sizes and only feed :func:`vmem_bytes` accounting; the CUDA kernels
pick their own tiles, take ``bk`` as the largest K block of their ring,
and mask ragged edges.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_int8.ops import MAX_SMEM_BYTES, _device_sms
from repro_torch.kernels.quant import reciprocal, requant_epilogue
from repro_torch.kernels.stream_matmul.ref import (result_dtype,
                                                   stream_matmul_ref)

__all__ = ["stream_matmul", "stream_matmul_requant", "vmem_bytes",
           "mm_plan", "mm_layout", "mm_bytes_read", "MmPlan", "KERNELS",
           "mm_float_plan", "mm_float_layout", "mm_float_parts",
           "MmFloatPlan",
           "mm_float_tensor_cores", "mm_float_kstep", "mm_float_shares",
           "float_instance", "FLOAT_KERNELS", "FLOAT_DTYPES",
           "FLOAT_TYPE_CODES"]

#: launch-counter name per mode ("pinned"/"stream" replace _mm_kernel,
#: "fifo" replaces _mm_manual_kernel): int8 operands, and the float modes
KERNELS = {m: f"stream_matmul_{m}" for m in ("pinned", "stream", "fifo")}
FLOAT_KERNELS = {"pinned": "stream_matmul_float_pinned",
                 "stream": "stream_matmul_float_pinned",
                 "fifo": "stream_matmul_float_fifo"}
#: operand types of the float modes, in any pair but int8 x int8
#: (``mm_kernel``'s), and their codes in ``stream_matmul_float_launch``
FLOAT_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                    torch.int8: 3}
FLOAT_DTYPES = tuple(FLOAT_TYPE_CODES)
# their names in the kernels' instances
_FLOAT_TYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                     torch.float16: "f16", torch.int8: "int8"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("stream_matmul")
    if not getattr(lib, "_typed", False):
        lib.stream_matmul_int8_launch.argtypes = \
            [_P, _P, _P, _P, _F, _F, _P, _P, _P] + [_I] * 12 + [_P]
        lib.stream_matmul_int8_launch.restype = _I
        lib.stream_matmul_float_launch.argtypes = [_P, _P, _P] + [_I] * 14 \
            + [_P]
        lib.stream_matmul_float_launch.restype = _I
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


# The launch plan; ``csrc/stream_matmul.cu`` mirrors the layout
# (``mm_layout`` there) and takes the tiles, the K split and the ring from
# it.
MM_TM = 8                     # rows of x a CTA
MM_TILES = (64, 32)           # output columns a CTA, widest first
MM_MAX_SPLIT = 8              # CTAs of a cluster, at most (portable size)
MM_SLOT_MAX = 32768           # bytes of a streamed K block, at most
MM_SHORT_RANGE = 256          # K rows a CTA up to which 64 threads consume


def mm_consumers(kr: int) -> int:
    """Consumer threads of a CTA whose K range is ``kr`` rows (the .cu's
    ``consumers``): 64 for a short range, where summing the threads'
    shares takes longer than their MACs, else 128."""
    return 64 if kr <= MM_SHORT_RANGE else 128


@dataclass(frozen=True)
class MmPlan:
    """One launch: a CTA per (tile of ``tn`` columns, rank of a K split
    of ``split`` ranges of ``kr`` rows, tile of ``MM_TM`` rows of x); the
    ``split`` CTAs of a column tile form a cluster whose leader adds their
    sums.  Each CTA streams its range in blocks of ``kblk`` rows through
    ``nb`` slots; ``vec`` and ``xvec`` are the bytes a copy of w and of x
    (1: byte loads)."""
    tn: int
    split: int
    kr: int
    kblk: int
    nb: int
    vec: int
    xvec: int
    n_tiles: int
    m_tiles: int
    smem_bytes: int

    @property
    def grid(self) -> Tuple[int, int, int]:
        return self.n_tiles, self.split, self.m_tiles


def mm_layout(tn: int, kr: int, kblk: int, nb: int) -> int:
    """Shared-memory bytes of one CTA: the full and empty mbarriers of the
    ``nb`` slots, the x tile ``[MM_TM][kr rounded up to 16]``, the slots
    ``[nb][kblk][tn + 16]``, the consumer warps' sums ``[warps][MM_TM]
    [tn]`` and the cluster's sums ``[MM_TM][tn]`` (int32)."""
    return 16 * nb + MM_TM * -(-kr // 16) * 16 + nb * kblk * (tn + 16) \
        + (mm_consumers(kr) // 32 + 1) * MM_TM * tn * 4


def _mm_split(M: int, K: int, N: int, sm_count: int, unit: int = 16,
              tiles: Tuple[int, ...] = MM_TILES
              ) -> Tuple[int, int, int, int]:
    """(m_tiles, tn, n_tiles, split) of both kernels: the widest column
    tile of ``tiles`` whose CTAs reach a wave of ``sm_count`` with a split
    of at most ``MM_MAX_SPLIT``, else the narrowest; the split is the
    smallest power of two that reaches the wave, with every rank's range
    (of a multiple of ``unit`` rows) non-empty."""
    m_tiles = -(-M // MM_TM)
    tn = next((t for t in tiles
               if -(-N // t) * m_tiles * MM_MAX_SPLIT >= sm_count),
              tiles[-1])
    n_tiles = -(-N // tn)
    split = 1
    while split < MM_MAX_SPLIT and n_tiles * m_tiles * split < sm_count:
        split *= 2
    while split > 1 and (split - 1) * _range_rows(K, split, unit) >= K:
        split //= 2
    return m_tiles, tn, n_tiles, split


def _range_rows(K: int, split: int, unit: int = 16) -> int:
    """A rank's K range: ceil(K / split) rounded up to ``unit`` rows."""
    return -(-(-(-K // split)) // unit) * unit


@functools.lru_cache(maxsize=None)
def mm_plan(M: int, K: int, N: int, mode: str, bk: int, n_buffers: int,
            sm_count: int = 132) -> MmPlan:
    """Tiles, K split and ring of one int8 launch (:func:`_mm_split`).
    ``mode`` sets the ring (:func:`ring`): one block of the whole range
    pinned, else blocks of at most ``bk`` rows and ``MM_SLOT_MAX`` bytes,
    depth 2 (``stream``) or ``n_buffers`` (``fifo``).  Cached: it runs on
    every launch."""
    blk, depth = ring(mode, K, bk, n_buffers)
    if depth < 1:
        raise ValueError("n_buffers must be >= 1")
    m_tiles, tn, n_tiles, split = _mm_split(M, K, N, sm_count)
    kr = _range_rows(K, split)
    if mode == "pinned":
        kblk, nb = kr, 1
    else:
        cap = MM_SLOT_MAX // (tn + 16) // 16 * 16
        kblk = max(4, min(blk, kr, cap) // 4 * 4)
        nb = min(depth, -(-kr // kblk))
    vec = 16 if N % 16 == 0 else 8 if N % 8 == 0 else 4 if N % 4 == 0 \
        else 1
    xvec = 16 if K % 16 == 0 else 4 if K % 4 == 0 else 1
    smem = mm_layout(tn, kr, kblk, nb)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"matmul needs {smem} B of shared memory per "
                         f"block, more than {MAX_SMEM_BYTES}")
    return MmPlan(tn, split, kr, kblk, nb, vec, xvec, n_tiles, m_tiles,
                  smem)


# The float modes' plan; ``csrc/stream_matmul.cu`` mirrors the layout
# (``mm_float_layout`` there).
MM_FLOAT_CONSUMERS = 128      # consumer threads of a CTA on FFMA (4 warps)
MM_FLOAT_TC_CONSUMERS = 256   # on the tensor cores (8 warps)
MM_FLOAT_KBLK = 8             # K rows of a block on FFMA: a multiple of
MM_FLOAT_KBLK_I8 = 16         # this, or of this where x is int8
MM_FLOAT_TC_UNIT = 32         # on the tensor cores: K rows a warp takes at
                              # once; ranges and blocks a multiple of it
MM_TILES_TC = (128,) + MM_TILES   # their column tiles, widest first
MM_TMA_BOX = 128              # bytes of a TMA box's row (the swizzle's span)
MM_TMA_ROWS = 256             # rows of a box, at most
MM_TMA_SLOT_MAX = 32768       # bytes of a slot on the TMA route, at most


def mm_float_tensor_cores(x_bytes: int, w_bytes: int) -> bool:
    """Whether a pair runs on the tensor cores (``mm_float_tc``; the .cu's
    ``float_tensor_cores``): its weights are not f32 and it is not int8 x
    int8 (``mm_kernel``'s).  A bf16, f16 or int8 operand is exact in 16
    bits (int8 widened); an f32 x splits exactly into three bf16 parts, a
    product each on the same weights.  The f32 weights stay on FFMA
    (``mm_float``): a tf32 product would round them, and three parts would
    triple the products of the pairs that are already near their bound."""
    return w_bytes <= 2 and not x_bytes == w_bytes == 1


def float_instance(x_dtype, w_dtype, tn: int) -> str:
    """The kernel instance a float pair launches at column tile ``tn``, as
    the build names it: ``mm_float_tc<f32,int8,128>`` on the tensor cores
    (:func:`mm_float_tensor_cores`), else ``mm_float<bf16,f32,64>``; each
    launch is counted under it in ``_build.SHAPE_LAUNCHES``."""
    tc = mm_float_tensor_cores(torch.empty((), dtype=x_dtype).element_size(),
                               torch.empty((), dtype=w_dtype).element_size())
    return (f"{'mm_float_tc' if tc else 'mm_float'}<"
            f"{_FLOAT_TYPE_NAMES[x_dtype]},{_FLOAT_TYPE_NAMES[w_dtype]},{tn}>")


def mm_float_shares(tn: int, tensor_cores: bool) -> int:
    """The consumers' shares of a column (the .cu's ``float_shares``):
    every warp's on FFMA; on the tensor cores the warps of a column group
    of 16 (one at 128 columns)."""
    if not tensor_cores:
        return MM_FLOAT_CONSUMERS // 32
    return MM_FLOAT_TC_CONSUMERS // 32 // (tn // 16)


def mm_float_kstep(x_bytes: int, w_bytes: int) -> int:
    """K rows a block of the pair's plan is a multiple of."""
    if mm_float_tensor_cores(x_bytes, w_bytes):
        return MM_FLOAT_TC_UNIT
    return MM_FLOAT_KBLK_I8 if x_bytes == 1 else MM_FLOAT_KBLK


@dataclass(frozen=True)
class MmFloatPlan:
    """One launch of ``mm_float``: CTAs and cluster as :class:`MmPlan`;
    each CTA streams its K range in blocks of ``kblk`` rows of the
    weights and of x through ``nb`` slots; ``wvec`` and ``xvec`` are the
    bytes a copy of w and of x (2: plain copies of bf16 values);
    ``tensor_cores``: ``mm_float_tc`` runs it, else ``mm_float``;
    ``tma``: its slots come by TMA boxes, else by cp.async."""
    tn: int
    split: int
    kr: int
    kblk: int
    nb: int
    wvec: int
    xvec: int
    n_tiles: int
    m_tiles: int
    smem_bytes: int
    tensor_cores: bool
    tma: bool = False

    @property
    def grid(self) -> Tuple[int, int, int]:
        return self.n_tiles, self.split, self.m_tiles


def mm_float_slot(tn: int, kblk: int, x_bytes: int, w_bytes: int,
                  tma: bool = False) -> int:
    """Bytes of one slot: ``kblk`` weight rows of ``tn * w_bytes + 16``
    bytes, then ``MM_TM`` x rows of ``kblk * x_bytes + 16``; on the TMA
    route the same rows without the 16 bytes, as boxes of 128-byte rows."""
    pad = 0 if tma else 16
    return kblk * (tn * w_bytes + pad) + MM_TM * (kblk * x_bytes + pad)


def mm_float_parts(tn: int, kblk: int, x_bytes: int, w_bytes: int) -> int:
    """Bytes of an f32 x's parts (the .cu's ``x_parts_bytes``): on the
    tensor cores at a tile of more than 32 columns (``x_split_shared``;
    at 32 each warp splits x in registers), two buffers, each the three
    bf16 parts of a slot's x, ``[3][MM_TM]`` rows of ``kblk`` bf16 padded
    by 16 bytes; else none."""
    if not (x_bytes == 4 and tn > 32
            and mm_float_tensor_cores(x_bytes, w_bytes)):
        return 0
    return 2 * 3 * MM_TM * (2 * kblk + 16)


def mm_float_layout(tn: int, kblk: int, nb: int, x_bytes: int,
                    w_bytes: int, tma: bool = False) -> int:
    """Shared-memory bytes of one CTA: the full and empty mbarriers of the
    ``nb`` slots, (TMA) 1024 bytes to align the ring to the swizzle, the
    slots, the consumers' shares ``[shares][MM_TM][tn]``
    (:func:`mm_float_shares`) and the CTA's sums ``[MM_TM][tn]`` (f32);
    then an f32 x's parts (:func:`mm_float_parts`)."""
    tc = mm_float_tensor_cores(x_bytes, w_bytes)
    return 16 * nb + (1024 if tma else 0) \
        + nb * mm_float_slot(tn, kblk, x_bytes, w_bytes, tma) \
        + (mm_float_shares(tn, tc) + 1) * MM_TM * tn * 4 \
        + mm_float_parts(tn, kblk, x_bytes, w_bytes)


def _copy_bytes(row_bytes: int, elem_bytes: int) -> int:
    """The widest cp.async (16, 8, 4 bytes) that tiles a row of
    ``row_bytes``, else one element (a bf16, f16 or int8 row whose bytes
    are not a multiple of 4)."""
    return next((v for v in (16, 8, 4) if row_bytes % v == 0), elem_bytes)


@functools.lru_cache(maxsize=None)
def mm_float_plan(M: int, K: int, N: int, mode: str, bk: int,
                  n_buffers: int, x_bytes: int, w_bytes: int,
                  sm_count: int = 132) -> MmFloatPlan:
    """Tiles, K split and ring of one float launch, x and w of
    ``x_bytes`` and ``w_bytes`` an element (4: f32, 2: bf16 or f16, 1:
    int8).  Tiles and split as :func:`_mm_split` (on the tensor cores of
    ``MM_TILES_TC``, the widest of those that reach the wave that takes
    the TMA route below, else the widest; else of ``MM_TILES``); pinned,
    one block of
    the whole range, the split doubled (up to ``MM_MAX_SPLIT``) while that
    block does not fit; else blocks of at most ``max(bk, step)`` rows (a
    multiple of ``step``, :func:`mm_float_kstep`: ``MM_FLOAT_TC_UNIT`` on
    the tensor cores, where ranges are a multiple of it too; on FFMA
    ``MM_FLOAT_KBLK``, or ``MM_FLOAT_KBLK_I8`` where x is int8) and
    ``MM_SLOT_MAX`` bytes a slot, depth 2 (``stream``) or ``n_buffers``
    (``fifo``), never more slots than the range has blocks, an f32 x's
    parts (:func:`mm_float_parts`) counted in a slot's bytes.  On the
    tensor cores the slots come by TMA where w's and x's rows are a
    multiple of 16 bytes and a column tile is 128 or 256 bytes: K blocks
    of whole 128-byte boxes of x, at most ``MM_TMA_ROWS`` rows and
    ``MM_TMA_SLOT_MAX`` bytes a slot (pinned: where the range is such a
    block); else by cp.async.  Cached: it runs on every launch."""
    if x_bytes not in (1, 2, 4) or w_bytes not in (1, 2, 4):
        raise ValueError(f"element bytes {x_bytes}, {w_bytes}: f32 (4), "
                         f"bf16 or f16 (2) or int8 (1)")
    blk, depth = ring(mode, K, bk, n_buffers)
    if depth < 1:
        raise ValueError("n_buffers must be >= 1")
    tc = mm_float_tensor_cores(x_bytes, w_bytes)
    if not tc:
        return _float_plan(M, K, N, mode, blk, depth, x_bytes, w_bytes,
                           sm_count, MM_TILES)
    # the tensor cores: the widest tile that reaches the wave and takes the
    # TMA route, else the widest that reaches the wave
    m_tiles = -(-M // MM_TM)
    tiles = [t for t in MM_TILES_TC
             if -(-N // t) * m_tiles * MM_MAX_SPLIT >= sm_count] \
        or [MM_TILES_TC[-1]]
    plans = [_float_plan(M, K, N, mode, blk, depth, x_bytes, w_bytes,
                         sm_count, (t,)) for t in tiles]
    return next((p for p in plans if p.tma), plans[0])


def _float_plan(M: int, K: int, N: int, mode: str, blk: int, depth: int,
                x_bytes: int, w_bytes: int, sm_count: int,
                tiles: Tuple[int, ...]) -> MmFloatPlan:
    """:func:`mm_float_plan` with column tiles from ``tiles``, K blocks of
    at most ``blk`` rows and a ring of ``depth`` slots."""
    tc = mm_float_tensor_cores(x_bytes, w_bytes)
    unit = MM_FLOAT_TC_UNIT if tc else 16
    m_tiles, tn, n_tiles, split = _mm_split(M, K, N, sm_count, unit, tiles)
    if mode == "pinned":
        def fits(sp):
            return mm_float_layout(tn, _range_rows(K, sp, unit), 1, x_bytes,
                                   w_bytes) <= MAX_SMEM_BYTES
        while (not fits(split) and split < MM_MAX_SPLIT
               and (2 * split - 1) * _range_rows(K, 2 * split, unit) < K):
            split *= 2
    kr = _range_rows(K, split, unit)
    # an f32 x's parts count in a slot's bytes (a K row's share of them)
    parts = mm_float_parts(tn, 1, x_bytes, w_bytes) \
        - mm_float_parts(tn, 0, x_bytes, w_bytes)
    # the TMA route: rows of w and x a multiple of 16 bytes, a column tile
    # of one or two 128-byte boxes, K blocks of whole 128-byte boxes of x
    # and at most MM_TMA_ROWS rows
    xstep = MM_TMA_BOX // x_bytes
    tma = (tc and N * w_bytes % 16 == 0 and K * x_bytes % 16 == 0
           and tn * w_bytes in (MM_TMA_BOX, 2 * MM_TMA_BOX))
    if mode == "pinned":
        kblk, nb = kr, 1
        tma = tma and kr % xstep == 0 and kr <= MM_TMA_ROWS
    else:
        if tma:
            cap = MM_TMA_SLOT_MAX // (mm_float_slot(tn, 1, x_bytes, w_bytes,
                                                    True) + parts)
            kblk = min(blk, kr, cap, MM_TMA_ROWS) // xstep * xstep
            tma = kblk > 0
        if not tma:
            step = mm_float_kstep(x_bytes, w_bytes)
            per_row = tn * w_bytes + 16 + MM_TM * x_bytes + parts
            cap = (MM_SLOT_MAX - 16 * MM_TM) // per_row
            kblk = max(step, min(blk, kr, cap) // step * step)
        nb = min(depth, -(-kr // kblk))
    smem = mm_float_layout(tn, kblk, nb, x_bytes, w_bytes, tma)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"float matmul needs {smem} B of shared memory "
                         f"per block, more than {MAX_SMEM_BYTES}")
    return MmFloatPlan(tn, split, kr, kblk, nb,
                       _copy_bytes(N * w_bytes, w_bytes),
                       _copy_bytes(K * x_bytes, x_bytes), n_tiles, m_tiles,
                       smem, tc, tma)


def mm_bytes_read(plan: MmPlan, M: int, K: int, N: int) -> Tuple[int, int]:
    """(weight bytes, x bytes) one launch with ``plan`` reads from device
    memory: each tile of rows of x reads the weights once, each column
    tile reads x once."""
    return plan.m_tiles * K * N, plan.n_tiles * M * K


def _shapes(x, w) -> Tuple[int, int, int]:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    return x.shape[0], x.shape[1], w.shape[1]


def charge(M: int, K: int, N: int, x_bytes: int, w_bytes: int,
           out_bytes: int, *, mode: str, bk: int = 512,
           n_buffers: int = 2) -> _build.Charge:
    """K7's (``pinned``, ``stream``) and K8's (``fifo``) charge
    (``_build.Charge``): x [M,K] @ w [K,N] at
    the JAX call's blocks (bm = bn = 128, bk = K when pinned).  A body
    that casts its f32 sums to a narrower result (bf16) counts the cast."""
    bm, bn = min(128, M), min(128, N)
    bk = K if mode == "pinned" else min(bk, K)
    nm, nn, nk = -(-M // bm), -(-N // bn), -(-K // bk)
    acc_bytes = 4
    cast = int(out_bytes != acc_bytes)
    dot = 2 * bm * bk * bn
    if mode == "fifo":
        # a K loop in the body (a scan of nk trips), one (m, n) a step
        body = (nk * (dot + bk * bn + bm * K + bm * bk + bm * bn + 14)
                + (2 + cast) * bm * bn + 1 + min(n_buffers, nk))
        grid = nm * nn
    else:
        body = dot + bk * bn + bm * bk + (7 + cast) * bm * bn + 5
        grid = nm * nn * nk
    nbytes = M * K * x_bytes + K * N * w_bytes + M * N * out_bytes
    return _build.Charge(body * grid, nbytes, 2 * M * K * N)


def _launch_float(x, w, *, mode: str, bk: int, n_buffers: int):
    """The float modes on the card: ``mm_float_tc`` (bf16, f16 or int8
    weights; an int8 operand widened to the other's type in registers, an
    f32 x split into three bf16 parts) or ``mm_float`` (FFMA, f32
    weights) -> [M, N] of the promoted type; a launch that fails raises."""
    M, K, N = _shapes(x, w)
    dev = x.device
    xb, wb = x.element_size(), w.element_size()
    plan = mm_float_plan(M, K, N, mode, bk, n_buffers, xb, wb,
                         _device_sms(dev))
    _build.check_cuda_tensor(x, "x", x.dtype, dev)
    _build.check_cuda_tensor(w, "w", w.dtype, dev)
    out = torch.empty((M, N), dtype=result_dtype(x.dtype, w.dtype),
                      device=dev)
    err = _lib().stream_matmul_float_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        FLOAT_TYPE_CODES[x.dtype], FLOAT_TYPE_CODES[w.dtype], M, K, N,
        plan.tn, plan.split, plan.kr, plan.kblk, plan.nb, plan.wvec,
        plan.xvec, int(plan.tma), plan.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "stream_matmul (float)")
    _build.count_launch(FLOAT_KERNELS[mode],
                        float_instance(x.dtype, w.dtype, plan.tn),
                        cost=charge(M, K, N, xb, wb, out.element_size(),
                                    mode=mode, bk=bk, n_buffers=n_buffers))
    return out


def _launch(x, w, w_scale, bias, act_scale: float, *, mode: str, bk: int,
            n_buffers: int, relu: bool, raw: bool, want_float: bool):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise NotImplementedError(
            f"the CUDA requant matmul takes int8 operands, not {x.dtype} x "
            f"{w.dtype}")
    M, K, N = _shapes(x, w)
    dev = x.device
    plan = mm_plan(M, K, N, mode, bk, n_buffers, _device_sms(dev))
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
        ptr(out_f), ptr(out_i), M, K, N, int(relu), plan.tn, plan.split,
        plan.kr, plan.kblk, plan.nb, plan.vec, plan.xvec, plan.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "stream_matmul")
    # the charge of the reference's call, which writes int32 sums
    _build.count_launch(KERNELS[mode], cost=charge(
        M, K, N, 1, 1, 4, mode=mode, bk=bk, n_buffers=n_buffers))
    return out_i if raw else (out_q, out_f)


def stream_matmul(x: torch.Tensor, w: torch.Tensor, *, mode: str = "stream",
                  bk: int = 512, n_buffers: int = 2) -> torch.Tensor:
    """x: [M, K] @ w: [K, N] -> [M, N]: int32 for int8 operands, else the
    promoted type of ``jnp.promote_types`` (``ref.result_dtype``: f16 x f16
    -> f16, f16 x bf16 -> f32, int8 x bf16 -> bf16, int8 x f16 -> f16, any
    pair with f32 -> f32), summed in f32 on the card."""
    ring(mode, w.shape[0], bk, n_buffers)            # validates the mode
    if _build.runs_plain(x):
        return stream_matmul_ref(x, w)
    if x.dtype == torch.int8 and w.dtype == torch.int8:
        return _launch(x, w, None, None, 0.0, mode=mode, bk=bk,
                       n_buffers=n_buffers, relu=False, raw=True,
                       want_float=False)
    if x.dtype in FLOAT_DTYPES and w.dtype in FLOAT_DTYPES:
        return _launch_float(x, w, mode=mode, bk=bk, n_buffers=n_buffers)
    raise NotImplementedError(
        f"the CUDA matmul takes operands of f32, bf16, f16 or int8, not "
        f"{x.dtype} x {w.dtype}")


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
