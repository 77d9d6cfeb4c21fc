"""The launch plans of the HBM-streamed dense conv (K2,
``conv2d_int8/ops.py::stream_plan``, mirrored by
``csrc/conv2d_int8.cu::stream_layout``) and of the fc-head matmul (K7/K8,
``stream_matmul/ops.py::mm_plan``, mirrored by
``csrc/stream_matmul.cu::mm_layout``).

K2's plan at every dense conv shape of the six CNN configs compiled for
``NX2100`` and of the three mini nets for ``MINI``, each forced onto the
streamed tier, at batch 1 and 8: one CTA fits a block and matches its
layout, the CTAs cover every output row, column, channel and image once,
and the weight ring and the input stages, run as the kernel orders its
waits and arrivals, obey the credit rule at n_buffers 1, 2, 3 and k*k.
The matmul's plan at every fc shape (and N = 10, K = 100, M = 17): tiles,
cluster size, K ranges, copy widths, a wave of CTAs.  Then int64
emulations of what each kernel computes with its plan (K2's stages and
transposed weight slices, the matmul's ring, thread shares and cluster
sum) against the plain versions and the JAX kernels in interpret mode,
and VGG-16's tail (fc0, fc1, fc2) through both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cnn as jcfg
from repro.kernels.conv2d_int8.ops import conv2d_int8 as jax_conv
from repro.kernels.stream_matmul.ops import stream_matmul as jax_matmul
from repro.models.cnn import cnn_forward as jax_cnn_forward
from repro_torch.compiler import MINI, NX2100, compile, select_engine
from repro_torch.compiler.engines import _block
from repro_torch.configs import cnn
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.conv2d_int8.ops import (CONV_INSTANCES, CONV_MT,
                                                 CONV_NTILES, MAX_SMEM_BYTES,
                                                 STREAM_A_STAGES,
                                                 STREAM_SLICE_MAX,
                                                 STREAM_SMALL_M,
                                                 stream_bytes_read,
                                                 stream_layout, stream_plan)
from repro_torch.kernels.conv2d_int8.ref import (conv2d_int8_ref,
                                                 same_out_and_pad)
from repro_torch.kernels.stream_matmul.ops import (MM_MAX_SPLIT,
                                                   MM_SLOT_MAX, MM_TILES,
                                                   MM_TM, mm_bytes_read,
                                                   mm_layout, mm_plan)
from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref
from repro_torch.models.cnn import cnn_forward


def _shapes():
    """(dense conv shapes (h, w, C, C_out, k_h, k_w, stride), fc shapes
    (K, N)) of the six CNN configs compiled for NX2100 and the three mini
    nets for MINI, and the six configs' fc shapes."""
    nets = [(cfg, NX2100) for cfg in cnn.CNN_CONFIGS.values()] + [
        (getattr(cnn, n)(), MINI)
        for n in ("mini_resnet18", "mini_resnet50", "mini_mobilenet")]
    conv, fc, heads = set(), set(), set()
    for cfg, target in nets:
        for s in compile(cfg, target).plan.schedules:
            sp = s.spec
            engine = select_engine(sp).name
            if engine == "conv2d_int8":
                conv.add((sp.in_h, sp.in_w, sp.c_in, sp.c_out, sp.k_h,
                          sp.k_w, sp.stride))
            elif engine == "stream_matmul":
                fc.add((sp.c_in, sp.c_out))
                if target is NX2100:
                    heads.add((sp.c_in, sp.c_out))
    return sorted(conv), sorted(fc), heads


# and the fc shapes of the six configs (HEADS), which fill the card
K2_SHAPES, FC_SHAPES, HEADS = _shapes()
CASES = [(shape, batch) for shape in K2_SHAPES for batch in (1, 8)]


def test_shapes_cover_every_kind_of_streamed_layer():
    assert len(K2_SHAPES) >= 70
    assert {s[4] for s in K2_SHAPES} == {1, 3, 7}
    assert (7, 7, 512, 4096, 7, 7, 7) in K2_SHAPES        # VGG-16's fc0
    assert {(3, 2), (3, 1)} <= {(s[2], s[6]) for s in K2_SHAPES}  # stems
    assert {1000, 1280, 4096} <= {n for _, n in FC_SHAPES}


def _ranges(n, size):
    """[(lo, hi)] of the tiles of ``size`` over ``n``."""
    return [(lo, min(n, lo + size)) for lo in range(0, n, size)]


@pytest.mark.parametrize("case", CASES, ids=[
    "{}x{}x{}-{}-k{}x{}s{}-b{}".format(*s, b) for s, b in CASES])
def test_stream_plan_covers_and_fits(case):
    (h, w, c, co, k_h, k_w, s), batch = case
    plan = stream_plan(batch, h, w, c, co, k_h, k_w, s, 2)
    h_out, _ = same_out_and_pad(h, k_h, s)
    w_out, _ = same_out_and_pad(w, k_w, s)
    # every output row, image, column and channel once
    assert _ranges(h_out, plan.rows_per_band) == [
        (b * plan.rows_per_band, min(h_out, (b + 1) * plan.rows_per_band))
        for b in range(plan.bands)]
    assert [b for lo, hi in _ranges(batch, plan.g) for b in range(lo, hi)] \
        == list(range(batch)) and len(_ranges(batch, plan.g)) == plan.groups
    assert len(_ranges(w_out, plan.seg)) == plan.nseg
    assert len(_ranges(co, plan.n_tile)) == plan.co_tiles
    assert plan.grid == (plan.groups * plan.nseg, plan.co_tiles, plan.bands)
    # M: the batch rides it, up to a chunk of CONV_MT pixels
    assert plan.g * plan.seg <= CONV_MT
    if w_out <= CONV_MT:
        assert plan.nseg == 1 and plan.g == -(-batch // -(
            -batch // max(1, min(batch, CONV_MT // w_out))))
    # the instance and the slices
    assert plan.n_tile in CONV_NTILES
    assert 8 * plan.wn * plan.nf == plan.n_tile
    assert (plan.wn, plan.nf) == (
        (4, 1) if plan.g * plan.seg <= STREAM_SMALL_M and plan.n_tile == 32
        and plan.vec == 16 else CONV_INSTANCES[plan.n_tile])
    assert plan.kb % 32 == 0 and plan.kb * plan.n_tile <= STREAM_SLICE_MAX
    assert plan.nkb == -(-c // plan.kb) and (plan.nkb - 1) * plan.kb < c
    assert plan.taps == k_h * k_w
    assert plan.nb == min(2, plan.slices_per_row)
    assert plan.vec == max(v for v in (4, 8, 16) if co % v == 0)
    assert plan.veca == (max(v for v in (4, 8, 16) if c % v == 0)
                         if c % 4 == 0 else 1)
    # the layout the .cu recomputes, and the bytes the wrapper checks
    assert (plan.row_bytes, plan.smem_bytes) == stream_layout(
        plan.kb, plan.g, plan.seg, k_h, k_w, s, plan.nb, plan.n_tile)
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    # each output row reads every weight once per (image group, segment)
    wb, ib = stream_bytes_read(plan, h, w, c, co, k_h, k_w, s)
    assert wb == plan.groups * plan.nseg * h_out * k_h * k_w * c * co
    assert 0 < ib <= plan.co_tiles * h_out * k_h * batch * w * c * (
        1 + plan.nseg)


def _run_ring(rows, kh, kw, nkb, nb, producer_first, credit=True):
    """The weight ring and the input stages of ``conv_stream`` as the
    kernel orders its waits and arrivals (a wait on a barrier's phase
    parity P passes once the phase of parity P has completed, i.e. while
    the count of completed phases has the other parity).  The producer
    fills input stage 0, then per slice waits for the slot's empty
    barrier (parity phase ^ 1), stores, arrives on its full barrier, and
    at the stage's slice min(nb, kw) - 1 fills the next stage after its
    slot's empty barrier; the consumer per stage waits for its full
    barrier, per slice for the slot's, and arrives on both empty barriers.
    Run greedily, one side first, until both are done.  Asserts that no
    slot is overwritten before its slice is consumed (the credit rule),
    that every read sees the slice it expects, and that it never
    deadlocks.  Returns the (slot, slice) of every fill in order.  With
    ``credit=False`` the producer refills a slot without its empty
    barrier's wait, as a faulty kernel would."""
    spr = kh * nkb
    n_st = rows * spr
    n = n_st * kw
    jfill = min(nb, kw) - 1
    wslot, aslot = [None] * nb, [None] * STREAM_A_STAGES
    w_full, w_empty = [0] * nb, [0] * nb
    a_full, a_empty = [0] * STREAM_A_STAGES, [0] * STREAM_A_STAGES
    done_w, done_a = set(), set()
    fills = []

    def passes(count, parity):
        return (count & 1) != parity

    def producer():
        aslot[0] = 0
        a_full[0] += 1
        slot = phase = 0
        for x in range(n):
            if credit:
                yield lambda s=slot, p=phase: passes(w_empty[s], p ^ 1)
            assert wslot[slot] is None or wslot[slot] in done_w, (x, slot)
            wslot[slot] = x
            fills.append((slot, x))
            w_full[slot] += 1
            slot, phase = (0, phase ^ 1) if slot + 1 == nb else \
                (slot + 1, phase)
            st = x // kw
            if x % kw == jfill and st + 1 < n_st:
                s1 = st + 1
                sl = s1 % STREAM_A_STAGES
                par = ((s1 // STREAM_A_STAGES) & 1) ^ 1
                yield lambda: passes(a_empty[sl], par)
                assert aslot[sl] is None or aslot[sl] in done_a, (s1, sl)
                aslot[sl] = s1
                a_full[sl] += 1

    def consumer():
        slot = phase = aslot_i = aphase = 0
        for st in range(n_st):
            yield lambda s=aslot_i, p=aphase: passes(a_full[s], p)
            assert aslot[aslot_i] == st
            for j in range(kw):
                yield lambda s=slot, p=phase: passes(w_full[s], p)
                assert wslot[slot] == st * kw + j
                done_w.add(st * kw + j)
                w_empty[slot] += 1
                slot, phase = (0, phase ^ 1) if slot + 1 == nb else \
                    (slot + 1, phase)
            done_a.add(st)
            a_empty[aslot_i] += 1
            aslot_i, aphase = (0, aphase ^ 1) \
                if aslot_i + 1 == STREAM_A_STAGES else (aslot_i + 1, aphase)

    sides = [producer(), consumer()]
    if not producer_first:
        sides.reverse()
    waiting = [next(g) for g in sides]
    while any(w is not None for w in waiting):
        moved = False
        for i, g in enumerate(sides):
            while waiting[i] is not None and waiting[i]():
                moved = True
                waiting[i] = next(g, None)
        assert moved, "the ring deadlocks"
    assert len(done_w) == n and len(done_a) == n_st
    return fills


@pytest.mark.parametrize("case", CASES, ids=[
    "{}x{}x{}-{}-k{}x{}s{}-b{}".format(*s, b) for s, b in CASES])
def test_stream_ring_obeys_the_credit_rule(case):
    (h, w, c, co, k_h, k_w, s), batch = case
    for nb in sorted({1, 2, 3, k_h * k_w}):
        plan = stream_plan(batch, h, w, c, co, k_h, k_w, s, nb)
        assert plan.nb == min(nb, plan.slices_per_row)
        rows = min(plan.rows_per_band, 3)
        for first in (True, False):
            fills = _run_ring(rows, k_h, k_w, plan.nkb, plan.nb, first)
            # slice x always lands in slot x % nb: the ring never deepens
            assert fills == [(x % plan.nb, x) for x in range(len(fills))]


def test_ring_emulation_catches_a_refill_without_credit():
    """The check has teeth: a producer that skips the empty barrier's wait
    overwrites a slot its consumer has not read."""
    with pytest.raises(AssertionError):
        _run_ring(2, 3, 3, 1, 2, producer_first=True, credit=False)


def _same(got, want):
    got = np.asarray(got)
    assert got.dtype == np.asarray(want).dtype and np.array_equal(
        got, np.asarray(want))


def _emulate_stream(x, w, stride, plan):
    """What ``csrc/conv2d_int8.cu::conv_stream`` computes with ``plan``, in
    int64: per CTA and output row, every input stage (kernel row i, K
    block kk) as ``fill_stage`` writes it (garbage in the bytes it does
    not write), every weight slice transposed into K-contiguous rows with
    zeros past C and C_out, the A rows of pixel m (image m // seg, column
    m % seg, clamped to the CTA's last pixel) at the slot of padded
    column cw * s + j, K in steps of 32 up to the block's valid channels;
    only the valid pixels and channels are stored."""
    rng = np.random.default_rng(0)
    B, H, W, C = x.shape
    k_h, k_w, _, co = w.shape
    h_out, pad_t = same_out_and_pad(H, k_h, stride)
    w_out, pad_l = same_out_and_pad(W, k_w, stride)
    g, seg, kb, pix = plan.g, plan.seg, plan.kb, plan.kb + 16
    wpad = (seg - 1) * stride + k_w
    q = -(-wpad // stride)
    ph_kept = min(stride, k_w)
    M = g * seg
    out = np.full((B, h_out, w_out, co), -1, np.int64)
    for gs in range(plan.groups * plan.nseg):
        grp, sg = gs % plan.groups, gs // plan.groups
        b0, ow0 = grp * g, sg * seg
        for ct in range(plan.co_tiles):
            co0 = ct * plan.n_tile
            for band in range(plan.bands):
                r0 = band * plan.rows_per_band
                for r in range(r0, min(h_out, r0 + plan.rows_per_band)):
                    acc = np.zeros((M, plan.n_tile), np.int64)
                    for i in range(k_h):
                        ih = r * stride - pad_t + i
                        for kk in range(plan.nkb):
                            cb = kk * kb
                            cv = min(kb, C - cb)
                            st = rng.integers(-128, 128,
                                              (g, ph_kept * q, pix))
                            for gi in range(g):
                                for px in range(wpad):
                                    if px % stride >= k_w:
                                        continue
                                    iw = ow0 * stride - pad_l + px
                                    slot = px % stride * q + px // stride
                                    ok = 0 <= ih < H and 0 <= iw < W \
                                        and b0 + gi < B
                                    st[gi, slot, :cv] = x[b0 + gi, ih, iw,
                                                          cb:cb + cv] \
                                        if ok else 0
                            kcs = -(-cv // 32) * 32
                            for j in range(k_w):
                                wt = np.zeros((plan.n_tile, pix), np.int64)
                                n_ok = min(plan.n_tile, co - co0)
                                wt[:n_ok, :cv] = w[i, j, cb:cb + cv,
                                                   co0:co0 + n_ok].T
                                m = np.minimum(np.arange(M), M - 1)
                                gi, cw = m // seg, m % seg
                                slot = j % stride * q + cw + j // stride
                                a = st[gi, slot, :kcs]
                                acc += a @ wt[:, :kcs].T
                    for m in range(M):
                        b, ow = b0 + m // seg, ow0 + m % seg
                        if b < B and ow < w_out:
                            n_ok = min(plan.n_tile, co - co0)
                            out[b, r, ow, co0:co0 + n_ok] = acc[m, :n_ok]
    return out.astype(np.int32)


# (batch, h, w, C, C_out, k, stride, sm_count): two K blocks (C = 300 at a
# 64-channel tile: kb 160), the 7x7 stem (C = 3: byte copies), C = 12 and
# 24 (4- and 8-byte copies), a ragged C_out (36: 4-byte weight loads, two
# tiles), three column segments (w_out = 130), a batch the image groups do
# not divide (11 at 14 columns), a 1x1 at stride 2, an fc head as a conv
# (7x7 at stride 7 on a 7x7 map: M = batch), one SM (tall bands), and an
# fc head on a 32-channel tile (M = 4: all four warps along N)
EMU_CASES = [
    (2, 9, 9, 300, 64, 3, 1, 1), (1, 16, 20, 3, 16, 7, 2, 132),
    (2, 9, 11, 12, 16, 3, 2, 132), (2, 8, 8, 24, 32, 3, 1, 1),
    (3, 6, 7, 48, 36, 3, 1, 132), (1, 4, 130, 16, 16, 3, 1, 132),
    (11, 28, 28, 32, 16, 1, 2, 132), (4, 7, 7, 40, 48, 7, 7, 132),
    (2, 12, 12, 64, 16, 3, 1, 1), (4, 7, 7, 40, 64, 7, 7, 2),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=[
    "b{}-{}x{}x{}-{}-k{}s{}-sm{}".format(*c) for c in EMU_CASES])
def test_emulated_stream_kernel_matches_reference_and_pallas(case):
    batch, h, w, c, co, k, s, sms = case
    rng = np.random.default_rng(h * 100 + c + co)
    x = rng.integers(-127, 128, (batch, h, w, c)).astype(np.int8)
    wt = rng.integers(-127, 128, (k, k, c, co)).astype(np.int8)
    plan = stream_plan(batch, h, w, c, co, k, k, s, 2, sms)
    got = _emulate_stream(x.astype(np.int64), wt.astype(np.int64), s, plan)
    want = conv2d_int8_ref(torch.from_numpy(x), torch.from_numpy(wt),
                           stride=s)
    _same(got, want.numpy())
    if h * w * batch <= 400:
        pallas = jax_conv(jnp.asarray(x), jnp.asarray(wt), stride=s,
                          stream=True, n_buffers=2, interpret=True)
        _same(got, pallas)


def test_emulated_cases_take_the_plan_paths_they_name():
    plans = {c: stream_plan(*c[:5], c[5], c[5], c[6], 2, c[7])
             for c in EMU_CASES}
    assert plans[EMU_CASES[0]].nkb == 2
    assert plans[EMU_CASES[1]].veca == 1
    assert {plans[EMU_CASES[2]].veca, plans[EMU_CASES[3]].veca} == {4, 8}
    assert plans[EMU_CASES[4]].vec == 4 and 36 % plans[EMU_CASES[4]].n_tile
    assert plans[EMU_CASES[5]].nseg == 3
    assert plans[EMU_CASES[6]].groups * plans[EMU_CASES[6]].g > 11
    assert plans[EMU_CASES[7]].g * plans[EMU_CASES[7]].seg == 4
    assert plans[EMU_CASES[8]].rows_per_band > 1
    assert (plans[EMU_CASES[9]].wn, plans[EMU_CASES[9]].nf) == (4, 1)


# ---------------------------------------------------------------------------
# the fc-head matmul
# ---------------------------------------------------------------------------

MM_CASES = [(8, k, n) for k, n in FC_SHAPES] + [(8, 25088, 4096),
                                                (3, 100, 10), (17, 512, 36),
                                                (17, 100, 10)]


@pytest.mark.parametrize("mode", ["pinned", "stream", "fifo"])
@pytest.mark.parametrize("case", MM_CASES, ids=[
    "m{}-k{}-n{}".format(*c) for c in MM_CASES])
def test_mm_plan_covers_and_fits(case, mode):
    M, K, N = case
    bk = _block(K, 512)
    if mode == "pinned" and K > 8192:
        with pytest.raises(ValueError, match="shared memory"):
            mm_plan(M, K, N, mode, bk, 2)
        return
    plan = mm_plan(M, K, N, mode, bk, 3)
    # every column, row of x and K row once: K ranges of kr rows, each
    # rank's range non-empty
    assert plan.tn in MM_TILES and len(_ranges(N, plan.tn)) == plan.n_tiles
    assert plan.m_tiles == -(-M // MM_TM)
    assert plan.split in (1, 2, 4, 8) and plan.split <= MM_MAX_SPLIT
    assert plan.kr % 16 == 0
    ranges = _ranges(K, plan.kr)
    assert len(ranges) == plan.split and all(lo < hi for lo, hi in ranges)
    assert plan.grid == (plan.n_tiles, plan.split, plan.m_tiles)
    if (K, N) in HEADS and M == 8:               # a wave of the card
        assert plan.n_tiles * plan.split * plan.m_tiles >= 132
    if plan.split > 1:                           # no wider split needed
        assert plan.n_tiles * plan.m_tiles * plan.split // 2 < 132 \
            or (plan.split - 1) * -(-K // (2 * plan.split) // 16) * 16 >= K
    # the ring of the mode
    if mode == "pinned":
        assert (plan.kblk, plan.nb) == (plan.kr, 1)
    else:
        assert plan.kblk % 4 == 0 and plan.kblk <= min(bk, plan.kr)
        assert plan.kblk * (plan.tn + 16) <= MM_SLOT_MAX
        depth = 2 if mode == "stream" else 3
        assert plan.nb == min(depth, -(-plan.kr // plan.kblk))
    # copies: 16 bytes where the rows allow, 8 at N = 1000, bytes at N = 10
    assert plan.vec == (16 if N % 16 == 0 else 8 if N % 8 == 0 else
                        4 if N % 4 == 0 else 1)
    assert plan.xvec == (16 if K % 16 == 0 else 4 if K % 4 == 0 else 1)
    assert plan.smem_bytes == mm_layout(plan.tn, plan.kr, plan.kblk,
                                        plan.nb) <= MAX_SMEM_BYTES
    assert mm_bytes_read(plan, M, K, N) == (plan.m_tiles * K * N,
                                            plan.n_tiles * M * K)


def _emulate_mm(x, w, plan):
    """What ``csrc/stream_matmul.cu::mm_kernel`` computes with ``plan``, in
    int64: per CTA (column tile, rank, row tile) the rank's K range in
    blocks of kblk rows (zeros past K, N and M), each of the 256 consumer
    threads summing its 4 columns over the K words way, way + ways, ... of
    each block, the shares added, and the leader adding every rank's sums
    through the cluster."""
    M, K = x.shape
    N = w.shape[1]
    quads = plan.tn // 4
    ways = 256 // quads
    out = np.zeros((M, N), np.int64)
    for nt in range(plan.n_tiles):
        n0 = nt * plan.tn
        for mt in range(plan.m_tiles):
            m0 = mt * MM_TM
            xs = np.zeros((MM_TM, K), np.int64)
            xs[:min(MM_TM, M - m0)] = x[m0:m0 + MM_TM]
            total = np.zeros((MM_TM, plan.tn), np.int64)
            for rank in range(plan.split):
                k0 = min(K, rank * plan.kr)
                k1 = min(K, k0 + plan.kr)
                red = np.zeros((ways, MM_TM, plan.tn), np.int64)
                for kb in range(-(-(k1 - k0) // plan.kblk)):
                    kbase = k0 + kb * plan.kblk
                    slot = np.zeros((plan.kblk, plan.tn), np.int64)
                    hi = min(k1, kbase + plan.kblk)
                    n_ok = min(plan.tn, N - n0)
                    slot[:hi - kbase, :n_ok] = w[kbase:hi, n0:n0 + n_ok]
                    rows = hi - kbase
                    for k4 in range(-(-rows // 4)):
                        way = k4 % ways
                        kk = slice(4 * k4, 4 * k4 + 4)
                        xk = np.zeros((MM_TM, 4), np.int64)
                        ks = slice(kbase + 4 * k4, min(k1, kbase + 4 * k4 + 4))
                        xk[:, :ks.stop - ks.start] = xs[:, ks]
                        red[way] += xk @ slot[kk]
                total += red.sum(axis=0)
            rows = min(MM_TM, M - m0)
            n_ok = min(plan.tn, N - n0)
            out[m0:m0 + rows, n0:n0 + n_ok] = total[:rows, :n_ok]
    return out.astype(np.int32)


# (M, K, N, mode, bk, n_buffers, sm_count): a 10-class head (byte copies,
# K = 100: 4-byte x copies), M = 17 (three row tiles), a ragged K split
# (K = 200: ranks of 64, 64, 64 and 8 rows), a stream ring of several
# blocks, and a fifo ring on one SM's plan
MM_EMU = [(3, 100, 10, "pinned", 64, 2, 132),
          (17, 512, 36, "fifo", 64, 3, 132),
          (8, 200, 40, "stream", 16, 2, 132),
          (8, 1024, 64, "stream", 32, 2, 132),
          (5, 96, 48, "fifo", 16, 2, 1)]


@pytest.mark.parametrize("case", MM_EMU, ids=[
    "m{}-k{}-n{}-{}-bk{}-nb{}-sm{}".format(*c) for c in MM_EMU])
def test_emulated_matmul_matches_reference_and_pallas(case):
    M, K, N, mode, bk, nb, sms = case
    rng = np.random.default_rng(M * K + N)
    x = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    plan = mm_plan(M, K, N, mode, bk, nb, sms)
    got = _emulate_mm(x.astype(np.int64), w.astype(np.int64), plan)
    _same(got, stream_matmul_ref(torch.from_numpy(x),
                                 torch.from_numpy(w)).numpy())
    if M % 8 == 0 and K % 16 == 0 and N % 8 == 0:
        pallas = jax_matmul(jnp.asarray(x), jnp.asarray(w), mode=mode, bm=8,
                            bk=16, bn=8, n_buffers=nb, interpret=True)
        _same(got, pallas)


def test_emulated_matmul_cases_split_k_over_a_cluster():
    plans = [mm_plan(*c[:6], c[6]) for c in MM_EMU]
    assert [p.split for p in plans[:3]] == [4, 8, 4]
    assert plans[2].kr * 3 < 200
    assert plans[0].vec == 1 and plans[0].xvec == 4
    assert plans[1].m_tiles == 3
    assert plans[3].nb == 2 and plans[3].kr > plans[3].kblk


# ---------------------------------------------------------------------------
# VGG-16's tail through both packages
# ---------------------------------------------------------------------------


def test_vgg16_tail_bit_identical_to_jax():
    """The last maxpool's 7x7x512 output at batch 2 through fc0 (the 7x7
    stride-7 conv-as-fc), fc1 and fc2 in both packages' ``cnn_forward``,
    with the same seeded weights: logits bit for bit.  Only the tail's
    weights are drawn; each layer's weight scale keeps its sums in the
    int8 range after requant."""
    tcfg, jc = cnn.get_cnn("vgg16"), jcfg.get_cnn("vgg16")
    names = [ly.name for ly in tcfg.layers]
    start = names.index("fc0")
    assert tcfg.layers[start - 1].kind == "maxpool"
    rng = np.random.default_rng(16)
    params = {}
    for ly in tcfg.layers[start:]:
        k = ly.k_h * ly.k_w * ly.c_in
        params[ly.name] = {
            "w": rng.integers(-127, 128, (ly.k_h, ly.k_w, ly.c_in, ly.c_out),
                              dtype=np.int8),
            "w_scale": (rng.uniform(1.0, 3.0, ly.c_out)
                        / (127 * np.sqrt(k))).astype(np.float32),
            "bias": rng.normal(0, 0.5, ly.c_out).astype(np.float32)}
    x = rng.integers(0, 128, (2, 7, 7, 512), dtype=np.int8)
    want = jax_cnn_forward({n: {k: jnp.asarray(v) for k, v in p.items()}
                            for n, p in params.items()}, jc, jnp.asarray(x),
                           layer_range=(start, len(names)))
    got = cnn_forward(params_from_numpy(params, "cpu"), tcfg,
                      torch.from_numpy(x), layer_range=(start, len(names)))
    assert got.shape == (2, 1000) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.abs().max()) > 0
