"""Wrappers: SAME maxpool and global average pool on the CUDA kernels or
their plain versions.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
``csrc/pool_int8.cu`` or raises.  Padding geometry comes from the conv
ops' ``same_out_and_pad``; maxpool pads with int8 -128.  The launch
plans are the pure functions :func:`pool_plan` (maxpool) and
:func:`gap_plan` (global average pool); the ``.cu`` mirrors their
layouts and refuses a plan whose shared-memory bytes differ.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_int8.ops import MAX_SMEM_BYTES, _device_sms
from repro_torch.kernels.conv2d_int8.ref import (same_out_and_pad,
                                                 same_padded_width)
from repro_torch.kernels.quant import reciprocal
from repro_torch.kernels.pool_int8.ref import (global_avgpool_int8_ref,
                                               maxpool_int8_ref)

__all__ = ["maxpool_int8", "global_avgpool_int8", "KERNEL_MAXPOOL",
           "KERNEL_GAP", "pool_plan", "pool_layout", "PoolPlan",
           "gap_plan", "GapPlan", "POOL_INSTANCES"]

KERNEL_MAXPOOL = "maxpool_int8"          # replaces _maxpool_kernel
KERNEL_GAP = "global_avgpool_int8"       # replaces _gap_kernel
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# The maxpool plan; ``csrc/pool_int8.cu`` mirrors the layout
# (``pool_layout`` there).
#: (k, stride) -> output columns a thread, for the windows with an
#: instance of their own; any other window runs the generic instance,
#: one column a thread
POOL_INSTANCES = {(3, 2): 4, (2, 2): 2}
POOL_THREADS = 256           # threads of a CTA, at most
POOL_MIN_THREADS = 128       # threads of a CTA, at least (they all stage)
POOL_SMEM_BUDGET = 48 * 1024  # staged bytes a CTA, at most (several CTAs
#                               an SM keep the copies in flight)
POOL_MIN_CHUNK = 64          # channels a CTA, at least, where C allows
POOL_MIN_SEG = 8             # output columns a segment split for CTAs
POOL_WAVES = 4               # CTAs to aim for, in waves of the card


@dataclass(frozen=True)
class PoolPlan:
    """One maxpool launch: a CTA per (band of ``rows`` output rows x
    segment of ``seg`` output columns, chunk of ``cc`` channels, image).
    It stages the ``(rows - 1) * s + k`` input rows by ``(seg - 1) * s +
    k`` columns under its windows in shared memory (``vec``-byte copies,
    16 where C % 16 == 0, else 4); each of its ``threads`` threads
    computes ``cols`` adjacent output columns of one ``vec``-byte channel
    group at a time."""
    rows: int
    bands: int
    seg: int
    segs: int
    cc: int
    c_tiles: int
    vec: int
    cols: int
    threads: int
    smem_bytes: int


def pool_layout(rows: int, seg: int, cc: int, k: int,
                s: int) -> Tuple[int, int, int]:
    """(staged rows, staged columns, shared-memory bytes) of one CTA: the
    input rows and columns its windows cover, ``cc`` bytes a pixel."""
    srows, scols = (rows - 1) * s + k, (seg - 1) * s + k
    return srows, scols, srows * scols * cc


@functools.lru_cache(maxsize=None)
def pool_plan(batch: int, h: int, w: int, c: int, k: int, s: int,
              sm_count: int = 132) -> PoolPlan:
    """The maxpool launch plan, aiming at ``POOL_WAVES`` waves of
    ``sm_count`` CTAs (many small CTAs an SM keep its copies in flight
    while others reduce).  Channel chunks halve (down to
    ``POOL_MIN_CHUNK`` channels) while one-row bands give fewer CTAs;
    where windows overlap (k > s) a band holds two output rows, so the
    rows they share are read once; column segments (a multiple of the
    columns a thread) halve while the CTAs still fall short (down to
    ``POOL_MIN_SEG``) or the stage exceeds ``POOL_SMEM_BUDGET``; then the
    bands double while the CTAs still reach the aim.  Cached: it runs on
    every launch."""
    if c % 4:
        raise ValueError(f"maxpool kernel needs C % 4 == 0, got C={c}")
    if k < 1 or s < 1:
        raise ValueError(f"maxpool window {k}, stride {s}")
    vec = 16 if c % 16 == 0 else 4
    h_out, _ = same_out_and_pad(h, k, s)
    w_out, _ = same_out_and_pad(w, k, s)
    cols = POOL_INSTANCES.get((k, s), 1)

    def ctas(rows, seg, cc):
        return batch * -(-h_out // rows) * -(-w_out // seg) * (c // cc)

    aim = POOL_WAVES * sm_count
    cc = c
    while (cc // 2 >= POOL_MIN_CHUNK and (cc // 2) % vec == 0
           and c % (cc // 2) == 0 and ctas(1, w_out, cc) < aim):
        cc //= 2
    rows = 2 if k > s and h_out >= 2 else 1
    seg = w_out
    while seg > cols and (
            pool_layout(rows, seg, cc, k, s)[2] > POOL_SMEM_BUDGET
            or (ctas(rows, seg, cc) < aim and seg >= 2 * POOL_MIN_SEG)):
        seg = -(-(-(-seg // 2)) // cols) * cols
    while (k > s and 2 * rows <= h_out and ctas(2 * rows, seg, cc) >= aim
           and pool_layout(2 * rows, seg, cc, k, s)[2] <= POOL_SMEM_BUDGET):
        rows *= 2
    smem = pool_layout(rows, seg, cc, k, s)[2]
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"maxpool needs {smem} B of shared memory per "
                         f"block, more than {MAX_SMEM_BYTES}")
    items = rows * -(-seg // cols) * (cc // vec)
    threads = min(POOL_THREADS, max(POOL_MIN_THREADS, -(-items // 32) * 32))
    return PoolPlan(rows, -(-h_out // rows), seg, -(-w_out // seg), cc,
                    c // cc, vec, cols, threads, smem)


# The global-average-pool plan; ``csrc/pool_int8.cu`` mirrors its layout
# (the warps' int32 sums [warps][cc] where a CTA has several warps).
GAP_THREADS = 256            # threads of a CTA, at most
GAP_PIX = 4                  # pixels a thread loads at once


@dataclass(frozen=True)
class GapPlan:
    """One global-average-pool launch: a CTA per (chunk of ``cc``
    channels, image) of ``warps`` warps; ``cc / vec`` lanes (at most 32)
    each load ``vec`` channels of a pixel (16-byte loads where C % 16 ==
    0, 4 where C % 4 == 0, else bytes), and the ``groups`` groups of
    lanes (32 / lanes a warp) share the pixels: group g takes pixels g, g
    + groups, ..., ``GAP_PIX`` loads in flight at a time.  The groups of
    a warp add their int32 sums by shuffles, the warps theirs in shared
    memory."""
    vec: int
    cc: int
    c_tiles: int
    groups: int
    warps: int
    smem_bytes: int

    @property
    def threads(self) -> int:
        return 32 * self.warps


@functools.lru_cache(maxsize=None)
def gap_plan(batch: int, h: int, w: int, c: int,
             sm_count: int = 132) -> GapPlan:
    """The widest channel chunk (``vec`` times a power of two, at most 32
    lanes) whose CTAs reach a wave of ``sm_count``, else the narrowest;
    as few warps as give each thread at most ``GAP_PIX`` pixels (at most
    ``GAP_THREADS`` threads).  Cached: it runs on every launch."""
    vec = 16 if c % 16 == 0 else 4 if c % 4 == 0 else 1
    cands = [vec]
    while cands[-1] < c and 2 * cands[-1] // vec <= 32:
        cands.append(2 * cands[-1])
    cc = next((x for x in reversed(cands) if batch * -(-c // x) >= sm_count),
              cands[0])
    per_warp = 32 // (cc // vec)                   # groups of lanes a warp
    warps = min(GAP_THREADS // 32, -(-(h * w) // (GAP_PIX * per_warp)))
    return GapPlan(vec, cc, -(-c // cc), warps * per_warp, warps,
                   warps * cc * 4 if warps > 1 else 0)


def _lib() -> ctypes.CDLL:
    lib = _build.load("pool_int8")
    if not getattr(lib, "_typed", False):
        lib.maxpool_int8_launch.argtypes = [_P, _P] + [_I] * 20 + [_P]
        lib.maxpool_int8_launch.restype = _I
        lib.global_avgpool_int8_launch.argtypes = [_P, _P] + [_I] * 10 \
            + [_F, _F, _P]
        lib.global_avgpool_int8_launch.restype = _I
        lib._typed = True
    return lib


def charge_maxpool(B: int, H: int, W: int, C: int, k: int,
                   stride: int) -> _build.Charge:
    """K5's charge (``_build.Charge``): SAME maxpool, int8 in and
    out."""
    h_pad, w_pad = (same_padded_width(H, k, stride),
                    same_padded_width(W, k, stride))
    h_out, w_out = -(-H // stride), -(-W // stride)
    T = k * k
    body = T * w_pad * C + 2 * T * w_out * C + 2 * w_out * C + 3
    return _build.Charge(body * B * h_out,
                  B * h_pad * w_pad * C + B * h_out * w_out * C, 0)


def charge_global_avgpool(B: int, H: int, W: int, C: int) -> _build.Charge:
    """K6's charge: [B,H,W,C] int8 -> [B,1,1,C] int8."""
    body = 2 * H * W * C + 9 * C + 2
    return _build.Charge(body * B, B * H * W * C + B * C, 0)


def maxpool_int8(x: torch.Tensor, *, k: int, stride: int) -> torch.Tensor:
    """SAME maxpool, int8 in / int8 out.
    x: [B, H, W, C] -> [B, ceil(H/s), ceil(W/s), C]."""
    if _build.runs_plain(x):
        return maxpool_int8_ref(x, k=k, stride=stride)
    B, H, W, C = x.shape
    plan = pool_plan(B, H, W, C, k, stride, _device_sms(x.device))
    _build.check_cuda_tensor(x, "x", torch.int8, x.device)
    h_out, pad_t = same_out_and_pad(H, k, stride)
    w_out, pad_l = same_out_and_pad(W, k, stride)
    out = torch.empty((B, h_out, w_out, C), dtype=torch.int8,
                      device=x.device)
    err = _lib().maxpool_int8_launch(
        x.data_ptr(), out.data_ptr(), B, H, W, C, h_out, w_out, k, stride,
        pad_t, pad_l, plan.rows, plan.bands, plan.seg, plan.segs, plan.cc,
        plan.c_tiles, plan.vec, plan.cols, plan.threads, plan.smem_bytes,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "maxpool_int8")
    _build.count_launch(KERNEL_MAXPOOL,
                        cost=charge_maxpool(B, H, W, C, k, stride))
    return out


def global_avgpool_int8(x: torch.Tensor, *,
                        act_scale: float = 0.05) -> torch.Tensor:
    """Global average pool + activation requantization, int8 in/out.
    x: [B, H, W, C] -> [B, 1, 1, C]."""
    if _build.runs_plain(x):
        return global_avgpool_int8_ref(x, act_scale=act_scale)
    B, H, W, C = x.shape
    plan = gap_plan(B, H, W, C, _device_sms(x.device))
    _build.check_cuda_tensor(x, "x", torch.int8, x.device)
    out = torch.empty((B, 1, 1, C), dtype=torch.int8, device=x.device)
    err = _lib().global_avgpool_int8_launch(
        x.data_ptr(), out.data_ptr(), B, H, W, C, plan.vec, plan.cc,
        plan.c_tiles, plan.groups, plan.warps, plan.smem_bytes,
        reciprocal(H * W), reciprocal(act_scale),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "global_avgpool_int8")
    _build.count_launch(KERNEL_GAP,
                        cost=charge_global_avgpool(B, H, W, C))
    return out
