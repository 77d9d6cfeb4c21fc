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
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_int8.ref import (conv2d_int8_ref,
                                                 same_out_and_pad,
                                                 same_padded_width)
from repro_torch.kernels.quant import reciprocal, requant_epilogue

__all__ = ["conv2d_int8", "conv2d_int8_requant", "same_padded_width",
           "smem_bytes", "dw_plan", "dw_layout", "DwPlan", "KERNEL_PINNED",
           "KERNEL_STREAM", "KERNEL_DW_PINNED", "KERNEL_DW_STREAM"]

KERNEL_PINNED = "conv2d_int8_pinned"     # replaces _conv_kernel
KERNEL_STREAM = "conv2d_int8_stream"     # replaces _conv_stream_kernel
KERNEL_DW_PINNED = "dwconv_int8_pinned"  # replaces _dwconv_kernel
KERNEL_DW_STREAM = "dwconv_int8_stream"  # replaces _dwconv_stream_kernel
MAX_SMEM_BYTES = 232448                  # what one H100 block may claim
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib(name: str, n_ints: int) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``; both launch functions take 4
    pointers, 2 floats, 3 output pointers, ``n_ints`` ints and the
    stream."""
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = [_P, _P, _P, _P, _F, _F, _P, _P, _P] + [_I] * n_ints \
            + [_P]
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


# The depthwise kernel's launch plan; ``csrc/dwconv_int8.cu`` mirrors
# the layout (``layout`` there) and takes quads, groups and rows_per_band
# from it.
DW_MAX_THREADS = 256      # compute threads of a CTA, at most
DW_PRODUCER = 32          # the streamed tier's tap-fetching warp
DW_COLS = (8, 4)          # consecutive output columns a thread may own
DW_WARPS_PER_SM = 12      # below this with 8 columns a thread, take 4
                          # (stride 2 only)
DW_PREFETCH = 2           # output rows whose input rows are in flight ahead
DW_KERNEL_SIZES = (1, 3, 5, 7)
# compute threads per SM the bands aim for: more for the streamed tier,
# whose per-row tap chain needs more rings in flight
DW_THREADS_PER_SM = {False: 512, True: 1024}


@dataclass(frozen=True)
class DwPlan:
    """One launch of the depthwise kernel: a CTA per (channel tile of
    ``4 * quads`` channels, band of ``rows_per_band`` output rows, image),
    whose compute threads are ``quads`` x ``groups`` column groups of
    ``cols`` output columns each."""
    quads: int
    cols: int
    groups: int
    c_tiles: int
    rows_per_band: int
    bands: int
    batch: int
    ring_rows: int        # input-row slots of the ring
    tap_slots: int        # streamed tier: min(n_buffers, k*k); pinned: 0
    row_words: int        # 32-bit words of one ring row (bank gaps in)
    smem_bytes: int
    threads: int          # compute threads (a whole number of warps) and,
                          # in the streamed tier, the producer warp

    @property
    def grid(self) -> Tuple[int, int, int]:
        return self.c_tiles, self.bands, self.batch


def dw_bank_gap(quads: int, stride: int, nc: int) -> int:
    """Words of gap after every ``nc * stride`` columns of a ring row (one
    column group's span): the next group's first word lands on the bank
    after this group's last, so a warp's lanes read 32 consecutive
    banks."""
    return quads * (1 - nc * stride) % 32


def dw_layout(w_out: int, k: int, stride: int, nc: int, quads: int,
              stream: bool, n_buffers: int) -> Tuple[int, int, int, int]:
    """(ring rows, tap slots, words of a ring row, shared-memory bytes) of
    one CTA whose threads own ``nc`` output columns each: 2 mbarriers and
    a slot of ``quads`` words per streamed tap, then ``k + DW_PREFETCH *
    stride`` input rows of ``quads`` words a column for the columns a
    thread's windows read, with a bank gap (``dw_bank_gap``) after every
    ``nc * stride`` columns."""
    period = nc * stride
    chunks = -(-w_out // nc)
    ndp = -(-k // 4)                         # dp4a words per kernel row
    nt4 = -(-((nc - 1) * stride + 4 * ndp) // 4)
    cols = max((chunks - 1) * period + 4 * nt4, (w_out - 1) * stride + k)
    row_words = cols * quads + dw_bank_gap(quads, stride, nc) * \
        ((cols - 1) // period)
    ring = k + DW_PREFETCH * stride
    slots = min(n_buffers, k * k) if stream else 0
    return ring, slots, row_words, slots * (quads * 4 + 16) \
        + ring * row_words * 4


def _dw_tile(batch: int, h_out: int, w_out: int, c: int, k: int,
             stride: int, nc: int, stream: bool, n_buffers: int,
             sm_count: int):
    """The tile and column groups with the fewest idle thread slots for
    threads of ``nc`` columns: (quads, groups, tiles, threads, layout) or
    None where no tile fits in shared memory."""
    vec = 4 if c % 16 == 0 else 2 if c % 8 == 0 else 1
    cq = c // 4
    chunks = -(-w_out // nc)
    best, seen = None, set()
    for n in range(1, cq + 1):
        quads = -(-(-(-cq // n)) // vec) * vec
        if quads in seen or quads > DW_MAX_THREADS:
            continue
        seen.add(quads)
        tiles = -(-cq // quads)
        layout = dw_layout(w_out, k, stride, nc, quads, stream, n_buffers)
        if layout[3] > MAX_SMEM_BYTES:
            continue
        for groups in range(1, chunks + 1):
            threads = -(-quads * groups // 32) * 32
            if threads > DW_MAX_THREADS:
                break
            rounds = -(-chunks // groups)
            key = (tiles * threads * rounds, rounds,
                   -min(tiles * batch * h_out, 4 * sm_count), -quads)
            if best is None or key < best[0]:
                best = (key, (quads, groups, tiles, threads, layout))
    return None if best is None else best[1]


@functools.lru_cache(maxsize=None)
def dw_plan(batch: int, h: int, w: int, c: int, k: int, stride: int,
            stream: bool, n_buffers: int, sm_count: int = 132) -> DwPlan:
    """The channel tile, columns a thread, column groups, bands and shared
    memory of one depthwise launch.

    A thread owns one quad of channels and 8 consecutive output columns,
    or 4 at stride 2 where 8 would leave fewer than ``DW_WARPS_PER_SM``
    warps a SM with one-row bands (4 columns halve each thread's serial
    work and double the warps; at stride 1 the extra halo words of a
    4-column window cost more than that gains on the H100).  The tile (``quads``, a
    multiple of the copy width) and the column groups leave the fewest
    idle thread slots: channel tiles x threads (whole warps) x rounds of
    column chunks; then the fewest rounds, enough CTAs for 4 per SM, and
    the widest tile.  The bands aim at ``DW_THREADS_PER_SM`` compute
    threads per SM.  Cached: the search runs in Python and would
    otherwise add to the host time of every launch."""
    if k not in DW_KERNEL_SIZES:
        raise ValueError(f"depthwise kernel size {k} not in "
                         f"{DW_KERNEL_SIZES}")
    if stride not in (1, 2):
        raise ValueError(f"depthwise stride {stride} not in (1, 2)")
    if c % 4:
        raise ValueError(f"C={c} must be a multiple of 4")
    if n_buffers < 1:
        raise ValueError("n_buffers must be >= 1")
    h_out, _ = same_out_and_pad(h, k, stride)
    w_out, _ = same_out_and_pad(w, k, stride)
    pick = None
    for nc in DW_COLS if stride == 2 else DW_COLS[:1]:
        tile = _dw_tile(batch, h_out, w_out, c, k, stride, nc, stream,
                        n_buffers, sm_count)
        if tile is None:
            continue
        pick = (nc, tile)
        _, _, tiles, threads, _ = tile
        if tiles * batch * h_out * threads // 32 >= \
                DW_WARPS_PER_SM * sm_count:
            break
    if pick is None:
        raise ValueError(f"dwconv of width {w_out} needs more than "
                         f"{MAX_SMEM_BYTES} B of shared memory per block")
    nc, (quads, groups, tiles, threads, layout) = pick
    ring, slots, row_words, smem = layout
    want = -(-sm_count * DW_THREADS_PER_SM[bool(stream)] // threads)
    bands = min(max(-(-want // (tiles * batch)), 1), h_out)
    rows = -(-h_out // bands)
    return DwPlan(quads, nc, groups, tiles, rows, -(-h_out // rows), batch,
                  ring, slots, row_words, smem,
                  threads + (DW_PRODUCER if stream else 0))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    err = _lib("conv2d_int8", 15).conv2d_int8_launch(
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
    if k_h != k_w:
        raise ValueError(f"depthwise kernel {k_h}x{k_w} is not square")
    dev = x.device
    plan = dw_plan(B, H, W, C, k_h, stride, stream, n_buffers,
                   _sm_count(dev.index if dev.index is not None
                             else torch.cuda.current_device()))
    h_out, pad_t = same_out_and_pad(H, k_h, stride)
    w_out, pad_l = same_out_and_pad(W, k_w, stride)
    out_q, out_f, out_i = _outputs(x, w, w_scale, bias, (B, h_out, w_out, C),
                                   raw, want_float)
    err = _lib("dwconv_int8", 18).dwconv_int8_launch(
        _ptr(x), _ptr(w), _ptr(w_scale), _ptr(bias), act_scale,
        0.0 if raw else reciprocal(act_scale), _ptr(out_q), _ptr(out_f),
        _ptr(out_i), B, H, W, C, h_out, w_out, k_h, k_w, stride, pad_t,
        pad_l, plan.quads, plan.cols, plan.groups, plan.rows_per_band,
        int(stream), n_buffers, int(relu),
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
