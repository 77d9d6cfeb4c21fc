"""Wrappers: SAME int8 conv (+ fused requant) on the CUDA kernel or its
plain version.

``stream=True`` selects the HBM-streamed weight tier (taps re-read once
per output row through an ``n_buffers``-deep shared-memory ring); the
placement plan (core/schedule.py) flips that switch per layer.  A CPU
tensor runs the plain version in ``ref.py``; a CUDA tensor launches
``csrc/conv2d_int8.cu`` (dense, on the int8 tensor cores: the pinned
tier with the launch plan of :func:`conv_plan`, the streamed tier with
that of :func:`stream_plan`) or ``csrc/dwconv_int8.cu``
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
           "stream_plan", "stream_layout", "stream_bytes_read", "StreamPlan",
           "STREAM_MAX_W_OUT", "conv_plan",
           "conv_layout", "ConvPlan",
           "stem_k_index", "dw_plan", "dw_layout", "DwPlan", "KERNEL_PINNED",
           "KERNEL_STREAM", "KERNEL_DW_PINNED", "KERNEL_DW_STREAM"]

KERNEL_PINNED = "conv2d_int8_pinned"     # replaces _conv_kernel
KERNEL_STREAM = "conv2d_int8_stream"     # replaces _conv_stream_kernel
KERNEL_DW_PINNED = "dwconv_int8_pinned"  # replaces _dwconv_kernel
KERNEL_DW_STREAM = "dwconv_int8_stream"  # replaces _dwconv_stream_kernel
MAX_SMEM_BYTES = 232448                  # what one H100 block may claim
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib(name: str, launchers) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, its launch functions typed:
    ``launchers`` maps each name to its count of ints.  Each takes 4
    pointers, 2 floats, 3 output pointers, the ints and the stream."""
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        for fname, n_ints in launchers.items():
            fn = getattr(lib, fname)
            fn.argtypes = [_P, _P, _P, _P, _F, _F, _P, _P, _P] \
                + [_I] * n_ints + [_P]
            fn.restype = _I
        lib._typed = True
    return lib


# The pinned dense conv's launch plan; ``csrc/conv2d_int8.cu`` mirrors the
# layout (``layout`` there) and takes the instance, rows a band and the
# stem packing from it.
CONV_MT = 64                  # output pixels a chunk (the CTA's M step)
# output channels a CTA, widest first -> the conv_mma<PACKED, WN, NF>
# instance that computes it: WN warps along N, NF 8-channel MMA columns a
# warp (n_tile = 8 * WN * NF)
CONV_INSTANCES = {64: (2, 4), 32: (1, 4), 16: (1, 2)}
CONV_NTILES = tuple(CONV_INSTANCES)
CONV_SM_SMEM = 233472         # shared memory of one SM (228 KB)
CONV_CTAS_PER_SM = 4          # at most: CTAS_PER_SM of the launch bounds
CONV_WAVE = 0.9               # the share of a wave the bands reach at least


@dataclass(frozen=True)
class ConvPlan:
    """One launch of the pinned dense conv: a CTA per (C_out tile of
    ``n_tile`` channels, band of ``rows_per_band`` output rows, image)
    walks the band's output pixels in chunks of ``CONV_MT``.  ``packed``:
    the stem's body, whose K is the whole (k_h, k_w, C) patch.  ``wn``
    and ``nf`` name the ``conv_mma`` instance (``CONV_INSTANCES``)."""
    packed: bool
    n_tile: int
    wn: int
    nf: int
    co_tiles: int
    rows_per_band: int
    bands: int
    batch: int
    taps: int             # K groups: k_h * k_w, or 1 when packed
    kp: int               # K bytes a tap, a multiple of 32
    ring_rows: int        # input rows of the line-buffer ring
    row_bytes: int        # bytes of one ring row
    smem_bytes: int

    @property
    def grid(self) -> Tuple[int, int, int]:
        return self.co_tiles, self.bands, self.batch


def conv_packed(c_in: int) -> bool:
    """Whether the pinned kernel packs the whole (k_h, k_w, C) patch into
    K (the stems' C = 3: a k32 step per tap would be 90% padding)."""
    return c_in < 16 or c_in % 4 != 0


def stem_k_index(k_h: int, k_w: int, c_in: int):
    """The packed stem's K order: k = (i * k_w + j) * C + c for tap (i, j)
    and input channel c, the HWIO order of the weights, so the weights of
    K row k are ``w.reshape(-1, C_out)[k]``; returns [(i, j, c)] by k."""
    return [(i, j, c) for i in range(k_h) for j in range(k_w)
            for c in range(c_in)]


def conv_layout(c_in: int, w_out: int, k_h: int, k_w: int, stride: int,
                rows_per_band: int, packed: bool,
                n_tile: int) -> Tuple[int, int, int, int, int]:
    """(taps, kp, ring rows, bytes of a ring row, shared-memory bytes) of
    one CTA: the weights ``[taps][n_tile][kp + 16]``, the ring, and when
    packed a ``[CONV_MT][kp + 16]`` patch tile.  A ring row holds the
    padded row's pixels at ``kp + 16`` bytes each (the gap puts an
    ldmatrix's 8 rows in distinct banks), by stride phase, keeping the
    ``min(stride, k_w)`` phases an output reads; a packed ring row holds
    its raw ``C``-byte pixels.  The ring keeps the ``min(stride, k_h)``
    rows of each stride step an output reads (input row ``u`` of the band
    in ring row ``u // stride * rs + u % stride``), the rows two
    consecutive chunks read, and no more than the band reads."""
    taps = 1 if packed else k_h * k_w
    kp = -(-(k_h * k_w * c_in if packed else c_in) // 32) * 32
    wpad = (w_out - 1) * stride + k_w
    rs = min(stride, k_h)
    if packed:
        row_bytes = -(-wpad * c_in // 16) * 16
    else:
        row_bytes = min(stride, k_w) * -(-wpad // stride) * (kp + 16)
    ring = min(((2 * CONV_MT - 1) // w_out + 1) * rs + k_h,
               (rows_per_band - 1) * rs + k_h)
    smem = taps * n_tile * (kp + 16) + ring * row_bytes \
        + (CONV_MT * (kp + 16) if packed else 0)
    return taps, kp, ring, row_bytes, smem


@functools.lru_cache(maxsize=None)
def conv_plan(batch: int, h: int, w: int, c_in: int, c_out: int, k_h: int,
              k_w: int, stride: int, sm_count: int = 132) -> ConvPlan:
    """The C_out tile, bands and layout of one pinned dense conv launch.

    Per tile of ``CONV_NTILES`` (none wider than C_out but the narrowest)
    and per count of resident CTAs a SM (``CONV_CTAS_PER_SM`` down to 1),
    the bands aim at one CTA per resident slot of the card, and at least
    ``CONV_WAVE`` of a wave of ``sm_count`` CTAs where the rows allow,
    with more where the ring of taller bands would not fit a block; the
    layout must fit a block and that many CTAs a SM.  The plan takes
    the widest tile that keeps two CTAs (8 warps) a SM, else the widest
    that fits at all.  Fewer, taller bands reload the pinned weights less
    often.  Cached: it runs in Python on every launch."""
    if c_out % 4:
        raise ValueError(f"C_out={c_out} must be a multiple of 4")
    h_out, _ = same_out_and_pad(h, k_h, stride)
    w_out, _ = same_out_and_pad(w, k_w, stride)
    packed = conv_packed(c_in)
    fits = []
    for n_tile in CONV_NTILES:
        if n_tile > c_out and n_tile != CONV_NTILES[-1]:
            continue
        cells = -(-c_out // n_tile) * batch
        for resident in range(CONV_CTAS_PER_SM, 0, -1):
            bands = min(h_out, max(-(-int(CONV_WAVE * sm_count) // cells),
                                   round(sm_count * resident / cells), 1))
            while True:       # taller rings than a block holds: more bands
                rows = -(-h_out // bands)
                layout = conv_layout(c_in, w_out, k_h, k_w, stride, rows,
                                     packed, n_tile)
                smem = layout[4]
                if smem <= MAX_SMEM_BYTES or rows == 1:
                    break
                bands = min(h_out, 2 * bands)
            if smem <= MAX_SMEM_BYTES and \
                    CONV_SM_SMEM // (smem + 1024) >= resident:
                taps, kp, ring, row_bytes, _ = layout
                fits.append((resident, ConvPlan(
                    packed, n_tile, *CONV_INSTANCES[n_tile], cells // batch,
                    rows, -(-h_out // rows),
                    batch, taps, kp, ring, row_bytes, smem)))
                break
    if not fits:
        raise ValueError(f"conv {k_h}x{k_w} C={c_in} -> {c_out} at width "
                         f"{w_out} needs more than {MAX_SMEM_BYTES} B of "
                         f"shared memory per block")
    return next((p for r, p in fits if r >= 2), fits[0][1])


# The streamed dense conv's launch plan; ``csrc/conv2d_int8.cu`` mirrors
# the layout (``stream_layout`` there) and takes the instance, the image
# group, the column segment, the band and the K block from it.
STREAM_SLICE_MAX = 16384      # kb * n_tile, at most
STREAM_CTAS_PER_SM = 2        # the launch bounds' minimum blocks a SM
STREAM_A_STAGES = 2           # input-row stages in flight
STREAM_STAGING = 4            # raw weight slices staged (3 in flight)
STREAM_SMALL_M = 16           # pixels a CTA up to which warps split N only
STREAM_MAX_W_OUT = 256        # output columns the streamed tier takes


@dataclass(frozen=True)
class StreamPlan:
    """One launch of the streamed dense conv.  A CTA covers a C_out tile
    of ``n_tile`` channels, ``g`` images and ``seg`` output columns of a
    band of ``rows_per_band`` output rows: its M is the ``g * seg <=
    CONV_MT`` pixels of a row.  For each output row every (tap, K block)
    weight slice of ``kb`` input channels x ``n_tile`` passes once through
    a ring of ``nb`` shared-memory slots; the input rows come in stages of
    one (kernel row, K block), ``STREAM_A_STAGES`` deep.  ``vec`` and
    ``veca``: bytes a load of the weight rows and a copy of the input
    (1: plain byte loads)."""
    n_tile: int
    wn: int
    nf: int
    vec: int
    veca: int
    taps: int             # k_h * k_w
    kb: int               # K bytes a slice, a multiple of 32
    nkb: int              # K blocks: ceil(C / kb)
    nb: int               # ring slots: min(n_buffers, slices a row)
    g: int
    groups: int
    seg: int
    nseg: int
    co_tiles: int
    rows_per_band: int
    bands: int
    batch: int
    row_bytes: int        # bytes of one image's input row in a stage
    smem_bytes: int

    @property
    def grid(self) -> Tuple[int, int, int]:
        return self.groups * self.nseg, self.co_tiles, self.bands

    @property
    def slices_per_row(self) -> int:
        return self.taps * self.nkb


def stream_layout(kb: int, g: int, seg: int, k_h: int, k_w: int,
                  stride: int, nb: int, n_tile: int) -> Tuple[int, int]:
    """(bytes of one image's input row in a stage, shared-memory bytes) of
    one CTA: the full and empty mbarriers of the ``nb`` weight slots and
    of the ``STREAM_A_STAGES`` input stages (8 bytes each), the weight
    slots ``[nb][n_tile][kb + 16]`` (K-contiguous rows, a 16-byte gap so
    ldmatrix's 8 rows fall in distinct banks), and the stages ``[2][g]
    [row]``.  A stage row holds the ``(seg - 1) * stride + k_w`` padded
    input columns the segment reads, at ``kb + 16`` bytes a pixel, by
    stride phase (pixel p at ``(p % stride) * q + p // stride``, q =
    ceil(columns / stride)), keeping the ``min(stride, k_w)`` phases an
    output reads; then ``STREAM_STAGING`` slots of raw HWIO slices
    ``[kb][n_tile]`` the weights arrive in before their transpose."""
    wpad = (seg - 1) * stride + k_w
    q = -(-wpad // stride)
    row = min(stride, k_w) * q * (kb + 16)
    smem = 16 * (nb + STREAM_A_STAGES) + nb * n_tile * (kb + 16) \
        + STREAM_A_STAGES * g * row + STREAM_STAGING * kb * n_tile
    return row, smem


def stream_instance(n_tile: int, vec: int, m: int) -> Tuple[int, int]:
    """(warps along N, 8-channel MMA columns a warp) of the ``conv_stream``
    instance for a C_out tile, a weight-load width and the CTA's pixels
    ``m``: ``CONV_INSTANCES``, but a 32-channel tile of at most
    ``STREAM_SMALL_M`` pixels (VGG-16's fc0: 8) puts all four warps along
    N (16-byte loads only)."""
    if m <= STREAM_SMALL_M and n_tile == 32 and vec == 16:
        return 4, 1
    return CONV_INSTANCES[n_tile]


def _copy_width(n: int) -> int:
    return 16 if n % 16 == 0 else 8 if n % 8 == 0 else 4 if n % 4 == 0 \
        else 1


@functools.lru_cache(maxsize=None)
def stream_plan(batch: int, h: int, w: int, c_in: int, c_out: int,
                k_h: int, k_w: int, stride: int, n_buffers: int,
                sm_count: int = 132) -> StreamPlan:
    """The work split, K block and layout of one streamed dense conv
    launch.

    The columns of a row split into ``nseg`` segments of at most
    ``CONV_MT``; the images into groups of ``g``, as many as fill M
    (the batch rides M: batch 8 at 7x7 gives 56 pixels, at VGG-16's fc0
    8).  Per C_out tile (``CONV_NTILES``, none wider than C_out but the
    narrowest) and image group size (largest first), the K block is the
    largest multiple of 32 that splits C evenly with a slice of at most
    ``STREAM_SLICE_MAX`` bytes and keeps as many blocks a SM as one-row
    bands would fill (at most ``STREAM_CTAS_PER_SM``), else the largest
    that fits a block.  The plan takes the widest
    tile whose CTAs with one-row bands fill ``CONV_WAVE`` of a wave, else
    the narrowest; the bands then aim at one CTA per resident slot.
    Cached: it runs in Python on every launch."""
    if c_out % 4:
        raise ValueError(f"C_out={c_out} must be a multiple of 4")
    if n_buffers < 1:
        raise ValueError("n_buffers must be >= 1")
    h_out, _ = same_out_and_pad(h, k_h, stride)
    w_out, _ = same_out_and_pad(w, k_w, stride)
    nseg = -(-w_out // CONV_MT)
    seg = -(-w_out // nseg)
    k_pad = -(-c_in // 32) * 32
    picks = []
    for n_tile in CONV_NTILES:
        if n_tile > c_out and n_tile != CONV_NTILES[-1]:
            continue
        found = None
        for g in range(min(batch, CONV_MT // seg), 0, -1):
            groups = -(-batch // g)
            g = -(-batch // groups)
            # CTAs a SM worth keeping room for: no more than one-row bands
            # would bring
            want = min(STREAM_CTAS_PER_SM, -(-(-(-c_out // n_tile)) * groups
                                             * nseg * h_out // sm_count))
            fits = []
            for nkb in range(-(-k_pad // (STREAM_SLICE_MAX // n_tile)),
                             k_pad // 32 + 1):
                kb = -(-k_pad // nkb // 32) * 32
                if -(-c_in // kb) != nkb:
                    continue
                nb = min(n_buffers, k_h * k_w * nkb)
                row, smem = stream_layout(kb, g, seg, k_h, k_w, stride, nb,
                                          n_tile)
                if smem > MAX_SMEM_BYTES:
                    continue
                fits.append((CONV_SM_SMEM // (smem + 1024), kb, nkb, nb, row,
                             smem))
                if fits[-1][0] >= want:
                    break
            if fits:
                found = (g, groups, next((f for f in fits if f[0] >= want),
                                         fits[0]))
                break
        if found is not None:
            picks.append((n_tile, found))
    if not picks:
        raise ValueError(f"streamed conv {k_h}x{k_w} C={c_in} -> {c_out} at "
                         f"width {w_out} needs more than {MAX_SMEM_BYTES} B "
                         f"of shared memory per block")
    n_tile, (g, groups, (resident, kb, nkb, nb, row, smem)) = next(
        (p for p in picks if -(-c_out // p[0]) * -(-batch // p[1][0]) * nseg
         * h_out >= CONV_WAVE * sm_count), picks[-1])
    co_tiles = -(-c_out // n_tile)
    cells = co_tiles * groups * nseg
    slots = min(resident, STREAM_CTAS_PER_SM) * sm_count
    bands = min(h_out, max(1, -(-slots // cells)))
    rows = -(-h_out // bands)
    return StreamPlan(n_tile, *stream_instance(n_tile, _copy_width(c_out),
                                               g * seg), _copy_width(c_out),
                      _copy_width(c_in), k_h * k_w, kb, nkb, nb, g, groups,
                      seg, nseg, co_tiles, rows, -(-h_out // rows), batch,
                      row, smem)


def stream_bytes_read(plan: StreamPlan, h: int, w: int, c_in: int,
                      c_out: int, k_h: int, k_w: int,
                      stride: int) -> Tuple[int, int]:
    """(weight bytes, input bytes) one launch with ``plan`` reads from
    device memory.  Every (image group, column segment) reads the whole
    weight tensor once per output row, since each output row fetches its
    taps again (Eq. 2 counts them once per row per image: this is
    ``groups * nseg / batch`` of it).  Every C_out tile reads, per output
    row and kernel row, the input row's columns its segment covers in a
    kept stride phase, for each image; SAME padding is zero-filled, not
    read."""
    h_out, pad_t = same_out_and_pad(h, k_h, stride)
    w_out, pad_l = same_out_and_pad(w, k_w, stride)
    weights = plan.groups * plan.nseg * h_out * k_h * k_w * c_in * c_out
    rows = sum(0 <= r * stride - pad_t + i < h
               for r in range(h_out) for i in range(k_h))
    wpad = (plan.seg - 1) * stride + k_w
    cols = sum(px % stride < k_w and 0 <= sg * plan.seg * stride - pad_l
               + px < w for sg in range(plan.nseg) for px in range(wpad))
    return weights, plan.co_tiles * rows * plan.batch * cols * c_in


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


def _device_sms(dev: torch.device) -> int:
    """SMs of the CUDA device ``dev`` (the current one where it has no
    index): the launch plans size their grids from it."""
    return _sm_count(dev.index if dev.index is not None
                     else torch.cuda.current_device())


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


def charge(B: int, H: int, W: int, C: int, C_out: int, k_h: int, k_w: int,
         stride: int, *, depthwise: bool) -> _build.Charge:
    """K1–K4's charge (``_build.Charge``): x [B,H,W,C] int8 (the
    reference reads it SAME-padded), w
    ``[k_h,k_w,C,C_out]`` (``[k_h,k_w,1,C]`` depthwise) int8 -> int32
    ``[B,ceil(H/s),ceil(W/s),C_out]``.  Pinned and streamed weights
    charge alike: the ring's copies count no FLOPs.  The requantizing
    launches fuse the epilogue and write int8 where the reference's
    ``pallas_call`` writes int32 and the epilogue runs as separate
    elementwise ops: the charge is the ``pallas_call``'s."""
    h_pad, w_pad = (same_padded_width(H, k_h, stride),
                    same_padded_width(W, k_w, stride))
    h_out, w_out = -(-H // stride), -(-W // stride)
    T = k_h * k_w
    if depthwise:
        C_out = C
        dots = 0
        body = T * w_pad * C + 4 * T * w_out * C + 2 * T * C \
            + 2 * w_out * C + 4
        w_bytes = T * C
    else:
        dots = 2 * T * w_out * C * C_out
        body = (dots + T * w_out * C_out + T * w_out * C + T * C * C_out
                + T * w_pad * C + 2 * w_out * C_out + 4)
        w_bytes = T * C * C_out
    grid = B * h_out
    nbytes = B * h_pad * w_pad * C + w_bytes + 4 * B * h_out * w_out * C_out
    return _build.Charge(body * grid, nbytes, dots * grid)


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
    dev = x.device
    sms = _device_sms(dev)
    if stream and w_out > STREAM_MAX_W_OUT:
        raise ValueError(f"output width {w_out} > {STREAM_MAX_W_OUT} is not "
                         f"supported by the streamed tier")
    p = (stream_plan(B, H, W, C, c_out, k_h, k_w, stride, n_buffers, sms)
         if stream else conv_plan(B, H, W, C, c_out, k_h, k_w, stride, sms))
    shape = (B, h_out, w_out, c_out)
    out_q, out_f, out_i = _outputs(x, w, w_scale, bias, shape, raw,
                                   want_float)
    lib = _lib("conv2d_int8", {"conv2d_int8_launch": 18,
                               "conv2d_int8_stream_launch": 25})
    args = (_ptr(x), _ptr(w), _ptr(w_scale), _ptr(bias), act_scale,
            0.0 if raw else reciprocal(act_scale), _ptr(out_q), _ptr(out_f),
            _ptr(out_i), B, H, W, C, h_out, w_out, c_out, k_h, k_w, stride,
            pad_t, pad_l, int(relu))
    cuda_stream = torch.cuda.current_stream(dev).cuda_stream
    if stream:
        err = lib.conv2d_int8_stream_launch(
            *args, p.n_tile, p.vec, p.veca, p.kb, p.nkb, p.nb, p.g, p.groups,
            p.seg, p.nseg, p.rows_per_band, p.smem_bytes, cuda_stream)
    else:
        err = lib.conv2d_int8_launch(
            *args, p.wn, p.nf, p.rows_per_band, int(p.packed), p.smem_bytes,
            cuda_stream)
    _build.check(err, "conv2d_int8")
    _build.count_launch(KERNEL_STREAM if stream else KERNEL_PINNED,
                        cost=charge(B, H, W, C, c_out, k_h, k_w, stride,
                                    depthwise=False))
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
                   _device_sms(dev))
    h_out, pad_t = same_out_and_pad(H, k_h, stride)
    w_out, pad_l = same_out_and_pad(W, k_w, stride)
    out_q, out_f, out_i = _outputs(x, w, w_scale, bias, (B, h_out, w_out, C),
                                   raw, want_float)
    lib = _lib("dwconv_int8", {"dwconv_int8_launch": 18})
    err = lib.dwconv_int8_launch(
        _ptr(x), _ptr(w), _ptr(w_scale), _ptr(bias), act_scale,
        0.0 if raw else reciprocal(act_scale), _ptr(out_q), _ptr(out_f),
        _ptr(out_i), B, H, W, C, h_out, w_out, k_h, k_w, stride, pad_t,
        pad_l, plan.quads, plan.cols, plan.groups, plan.rows_per_band,
        int(stream), n_buffers, int(relu),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dwconv_int8")
    _build.count_launch(KERNEL_DW_STREAM if stream else KERNEL_DW_PINNED,
                        cost=charge(B, H, W, C, C, k_h, k_w, stride,
                                    depthwise=True))
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
