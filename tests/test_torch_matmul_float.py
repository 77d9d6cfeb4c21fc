"""The float modes of the streamed matmul (K7/K8 with f32 or bf16
operands) on the CPU.

The port's ``stream_matmul`` against the JAX package's Pallas kernels in
interpret mode, for every operand pair of f32 and bf16 in all three
modes: the same result type (bf16 for bf16 x bf16, f32 otherwise) and
values within ``tests/test_kernels.py``'s limits.  Then the launch plan
of the CUDA kernels (``stream_matmul/ops.py::mm_float_plan``, mirrored by
``csrc/stream_matmul.cu::mm_float_layout``; ``mm_float`` on FFMA for the
pairs with f32, ``mm_float_tc`` on the tensor cores for the others) at
the JAX tests' shapes, a ragged one and every fc head of the six CNN
configs: the CTAs' K ranges tile K exactly, the ring's depth is
``ring()``'s, shared memory fits a block; the ring's waits and arrivals
replayed in Python obey the credit rule; an f32 emulation of what each
body computes with its plan, in its order of sums, against the plain
version and the JAX kernel; the tensor-core body's fragment layout,
modelled lane by lane after PTX's ``ldmatrix`` and ``mma.sync``, against
the exact product of a tile; and a numpy model of the exact split of an
f32 x into three bf16 parts (``stream_matmul.cu::split3``) over every
binade and the edge values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stream_matmul.ops import stream_matmul as jax_matmul
from repro_torch.compiler import NX2100, compile, select_engine
from repro_torch.compiler.engines import _block
from repro_torch.configs.cnn import CNN_CONFIGS
from repro_torch.kernels.conv2d_int8.ops import MAX_SMEM_BYTES
from repro_torch.kernels.stream_matmul.ops import (FLOAT_KERNELS,
                                                   float_instance,
                                                   MM_FLOAT_CONSUMERS,
                                                   MM_FLOAT_KBLK,
                                                   MM_FLOAT_TC_CONSUMERS,
                                                   MM_FLOAT_TC_UNIT,
                                                   MM_MAX_SPLIT,
                                                   MM_SLOT_MAX, MM_TILES,
                                                   MM_TILES_TC, MM_TM,
                                                   MM_TMA_ROWS,
                                                   MM_TMA_SLOT_MAX,
                                                   mm_float_kstep,
                                                   mm_float_layout,
                                                   mm_float_plan,
                                                   mm_float_shares,
                                                   mm_float_slot,
                                                   mm_float_tensor_cores,
                                                   ring, stream_matmul)
from repro_torch.kernels.stream_matmul.ref import (result_dtype,
                                                   stream_matmul_ref)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
PAIRS = [(a, b) for a in DTYPES for b in DTYPES]
# (mode, n_buffers)
RINGS = [("pinned", 2), ("stream", 2), ("fifo", 1), ("fifo", 3)]


def _operands(rng, shape, xd, wd):
    """x, w from numpy, rounded to their types once, for both packages."""
    M, K, N = shape
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32),
                    DTYPES[xd][0])
    w = jnp.asarray(rng.normal(size=(K, N)).astype(np.float32),
                    DTYPES[wd][0])
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(DTYPES[xd][1])
    tw = torch.from_numpy(np.asarray(w, np.float32)).to(DTYPES[wd][1])
    return x, w, tx, tw


def _tol(out_dtype):
    """tests/test_kernels.py's limits: 2e-5 (f32), 2e-2 (bf16), as rtol
    and as a share of max |ref| for atol."""
    return 2e-2 if out_dtype == torch.bfloat16 else 2e-5


@pytest.mark.parametrize("m", [8, 16])
@pytest.mark.parametrize("mode,nb", RINGS)
@pytest.mark.parametrize("xd,wd", PAIRS)
def test_matmul_float_matches_pallas(xd, wd, mode, nb, m):
    rng = np.random.default_rng(m * 10 + nb)
    x, w, tx, tw = _operands(rng, (m, 64, 32), xd, wd)
    want = jax_matmul(x, w, mode=mode, bm=8, bk=16, bn=16, n_buffers=nb,
                      interpret=True)
    got = stream_matmul(tx, tw, mode=mode, bk=16, n_buffers=nb)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    want32 = np.asarray(want, np.float32)
    tol = _tol(got.dtype)
    np.testing.assert_allclose(got.float().numpy(), want32, rtol=tol,
                               atol=tol * float(np.abs(want32).max()))


@pytest.mark.parametrize("xd,wd", PAIRS + [("int8", "int8"),
                                            ("int8", "f32"),
                                            ("bf16", "int8")])
def test_result_dtype_is_the_jax_packages(xd, wd):
    jt = {**{k: v[0] for k, v in DTYPES.items()}, "int8": jnp.int8}
    tt = {**{k: v[1] for k, v in DTYPES.items()}, "int8": torch.int8}
    want = jnp.promote_types(jt[xd], jt[wd])
    want = jnp.int32 if want == jnp.int8 else want
    assert str(result_dtype(tt[xd], tt[wd])).split(".")[1] == \
        jnp.dtype(want).name
    got = stream_matmul_ref(torch.ones(2, 3, dtype=tt[xd]),
                            torch.ones(3, 4, dtype=tt[wd]))
    assert got.dtype == result_dtype(tt[xd], tt[wd])
    assert bool((got.float() == 3).all())


def _fc_heads():
    """(K, N) of every fc head the six CNN configs run on the matmul."""
    heads = set()
    for cfg in CNN_CONFIGS.values():
        for s in compile(cfg, NX2100).plan.schedules:
            if select_engine(s.spec).name == "stream_matmul":
                heads.add((s.spec.c_in, s.spec.c_out))
    return sorted(heads)


FC_HEADS = _fc_heads()
# the JAX tests' shapes, a ragged one, the fc heads at M = 8, and VGG-16's
# fc0 as a matmul (streamed only: its pinned block does not fit)
PLAN_SHAPES = [(128, 256, 128), (256, 1024, 384), (128, 512, 256),
               (17, 100, 36), (8, 25088, 4096)] + [(8, k, n)
                                                   for k, n in FC_HEADS]
BYTES = {"f32": 4, "bf16": 2}


def test_fc_heads_are_listed():
    assert len(FC_HEADS) >= 5
    assert {(512, 1000), (2048, 1000), (4096, 4096)} <= set(FC_HEADS)


def _ranges(n, size):
    return [(lo, min(n, lo + size)) for lo in range(0, n, size)]


@pytest.mark.parametrize("xd,wd", PAIRS)
@pytest.mark.parametrize("mode", ["pinned", "stream", "fifo"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=[
    "m{}-k{}-n{}".format(*s) for s in PLAN_SHAPES])
def test_mm_float_plan_covers_and_fits(shape, mode, xd, wd):
    M, K, N = shape
    xb, wb = BYTES[xd], BYTES[wd]
    bk = 128 if M > 8 else _block(K, 512)
    if mode == "pinned" and K > 8192:
        with pytest.raises(ValueError, match="shared memory"):
            mm_float_plan(M, K, N, mode, bk, 2, xb, wb)
        return
    for nb in (1, 2, 3, 4):
        plan = mm_float_plan(M, K, N, mode, bk, nb, xb, wb)
        # every column and row of x once; the ranks' K ranges tile K
        tiles = MM_TILES_TC if plan.tensor_cores else MM_TILES
        assert plan.tn in tiles and len(_ranges(N, plan.tn)) == \
            plan.n_tiles
        assert plan.m_tiles == -(-M // MM_TM)
        assert plan.split in (1, 2, 4, 8) and plan.split <= MM_MAX_SPLIT
        assert plan.kr % 16 == 0
        assert plan.tensor_cores == (wd == "bf16")
        if plan.tensor_cores:
            assert plan.kr % MM_FLOAT_TC_UNIT == 0
        ranges = _ranges(K, plan.kr)
        assert len(ranges) == plan.split and ranges[-1][1] == K
        assert all(lo < hi for lo, hi in ranges)
        assert plan.grid == (plan.n_tiles, plan.split, plan.m_tiles)
        if M == 8 and (K, N) in FC_HEADS:           # a wave of the card
            assert plan.n_tiles * plan.split >= 128
        # the blocks of a range cover it, the ring is ring()'s
        blk, depth = ring(mode, K, bk, nb)
        if mode == "pinned":
            assert (plan.kblk, plan.nb) == (plan.kr, 1)
        else:
            step = mm_float_kstep(xb, wb)
            assert plan.kblk % MM_FLOAT_KBLK == 0 and plan.kblk % step == 0
            assert plan.kblk <= max(step, blk)
            assert mm_float_slot(plan.tn, plan.kblk, xb, wb, plan.tma) <= (
                MM_TMA_SLOT_MAX if plan.tma else MM_SLOT_MAX)
            for lo, hi in ranges:
                blocks = _ranges(hi - lo, plan.kblk)
                assert blocks[-1][1] == hi - lo
            assert plan.nb == min(depth, -(-plan.kr // plan.kblk))
        # copies: 16 bytes where the rows allow, else 8, 4 or one bf16
        for vec, row, es in ((plan.wvec, N * wb, wb),
                             (plan.xvec, K * xb, xb)):
            assert row % vec == 0
            assert vec == next(v for v in (16, 8, 4, es) if row % v == 0)
        # TMA: rows of 16-byte multiples, 128-byte boxes of the column tile
        # and of x's K block, at most MM_TMA_ROWS rows a box
        if plan.tma:
            assert plan.tensor_cores and N * wb % 16 == 0 == K * xb % 16
            assert plan.tn * wb in (128, 256) and plan.kblk * xb % 128 == 0
            assert plan.kblk <= MM_TMA_ROWS
        assert plan.smem_bytes == mm_float_layout(
            plan.tn, plan.kblk, plan.nb, xb, wb, plan.tma) <= MAX_SMEM_BYTES


def test_mm_float_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="element bytes"):
        mm_float_plan(8, 64, 32, "fifo", 16, 2, 8, 4)
    with pytest.raises(ValueError, match="n_buffers"):
        mm_float_plan(8, 64, 32, "fifo", 16, 0, 4, 4)
    with pytest.raises(ValueError, match="mode"):
        mm_float_plan(8, 64, 32, "ring", 16, 2, 4, 4)


def test_float_kernels_count_pinned_and_stream_together():
    assert FLOAT_KERNELS == {"pinned": "stream_matmul_float_pinned",
                             "stream": "stream_matmul_float_pinned",
                             "fifo": "stream_matmul_float_fifo"}


def _run_ring(nkb, nb, warps, producer_first, credit=True):
    """The slots of ``mm_float`` run as the kernel orders its waits and
    arrivals: the producer per block waits for its slot's empty barrier
    (parity phase ^ 1), fills it and arrives on its full barrier; each of
    ``warps`` consumer warps waits for the full barrier (parity phase),
    reads the block and arrives on the empty barrier, which completes a
    phase once every warp has arrived.  Run greedily, one side first.
    Asserts that no slot is refilled before every warp has read it (the
    credit rule), that every read sees the block it expects, and that it
    never deadlocks.  Returns the (slot, block) of every fill.  With
    ``credit=False`` the producer skips the empty barrier's wait."""
    slot_of = [None] * nb
    full, empty = [0] * nb, [0] * nb
    arrived = [0] * nb
    reads = [set() for _ in range(nkb)]
    fills = []

    def passes(count, parity):
        return (count & 1) != parity

    def producer():
        slot = phase = 0
        for kb in range(nkb):
            if credit:
                yield lambda s=slot, p=phase: passes(empty[s], p ^ 1)
            old = slot_of[slot]
            assert old is None or len(reads[old]) == warps, (kb, slot)
            slot_of[slot] = kb
            fills.append((slot, kb))
            full[slot] += 1
            slot, phase = (0, phase ^ 1) if slot + 1 == nb else \
                (slot + 1, phase)

    def consumer(warp):
        slot = phase = 0
        for kb in range(nkb):
            yield lambda s=slot, p=phase: passes(full[s], p)
            assert slot_of[slot] == kb, (warp, kb, slot)
            reads[kb].add(warp)
            arrived[slot] += 1
            if arrived[slot] == warps:
                arrived[slot] = 0
                empty[slot] += 1
            slot, phase = (0, phase ^ 1) if slot + 1 == nb else \
                (slot + 1, phase)

    sides = [producer()] + [consumer(w) for w in range(warps)]
    if not producer_first:
        sides.reverse()
    waiting = [next(g, None) for g in sides]
    while any(w is not None for w in waiting):
        moved = False
        for i, g in enumerate(sides):
            while waiting[i] is not None and waiting[i]():
                moved = True
                waiting[i] = next(g, None)
        assert moved, "the ring deadlocks"
    assert all(len(r) == warps for r in reads)
    return fills


@pytest.mark.parametrize("shape", PLAN_SHAPES[:5], ids=[
    "m{}-k{}-n{}".format(*s) for s in PLAN_SHAPES[:5]])
def test_float_ring_obeys_the_credit_rule(shape):
    M, K, N = shape
    for mode in ("stream", "fifo"):
        for nb in (1, 2, 3, 4):
            for bk in (16, 128):
                plan = mm_float_plan(M, K, N, mode, bk, nb, 4, 2)
                nkb = -(-plan.kr // plan.kblk)
                for first in (True, False):
                    fills = _run_ring(nkb, plan.nb, MM_FLOAT_CONSUMERS // 32,
                                      first)
                    assert fills == [(b % plan.nb, b) for b in range(nkb)]


def test_float_ring_replay_catches_a_refill_without_credit():
    """The check has teeth: a producer that skips the empty barrier's wait
    overwrites a slot its consumers have not read (at n_buffers = 1)."""
    with pytest.raises(AssertionError):
        _run_ring(4, 1, 4, producer_first=True, credit=False)


@pytest.mark.parametrize("shape", PLAN_SHAPES[:5], ids=[
    "m{}-k{}-n{}".format(*s) for s in PLAN_SHAPES[:5]])
def test_tensor_core_ring_obeys_the_credit_rule(shape):
    """The tensor-core plans (bf16 x bf16, int8 x bf16, bf16 x int8, f32 x
    bf16, f32 x int8) keep the ring's contract: the same waits and
    arrivals, eight consumer warps a slot."""
    M, K, N = shape
    for xb, wb in ((2, 2), (1, 2), (2, 1), (4, 2), (4, 1)):
        for mode in ("stream", "fifo"):
            for nb in (1, 2, 3, 4):
                for bk in (16, 128):
                    plan = mm_float_plan(M, K, N, mode, bk, nb, xb, wb)
                    assert plan.tensor_cores
                    nkb = -(-plan.kr // plan.kblk)
                    for first in (True, False):
                        fills = _run_ring(nkb, plan.nb,
                                          MM_FLOAT_TC_CONSUMERS // 32, first)
                        assert fills == [(b % plan.nb, b)
                                         for b in range(nkb)]


def _tile_operands(plan, x, w, nt, mt, k0, kbase):
    """A slot's K block as the producer fills it: the weights [kblk][tn]
    and x [MM_TM][kblk], zeros past the range, N and M."""
    M, K = x.shape
    N = w.shape[1]
    n0, m0 = nt * plan.tn, mt * MM_TM
    n_ok, rows = min(plan.tn, N - n0), min(MM_TM, M - m0)
    hi = min(k0, kbase + plan.kblk)
    ws = np.zeros((plan.kblk, plan.tn), np.float32)
    ws[:hi - kbase, :n_ok] = w[kbase:hi, n0:n0 + n_ok]
    xs = np.zeros((MM_TM, plan.kblk), np.float32)
    xs[:rows, :hi - kbase] = x[m0:m0 + rows, kbase:hi]
    return ws, xs, hi - kbase


def _emulate(x, w, plan, tf32=False, split=False):
    """What the float body of ``plan`` computes, in f32.  Per CTA (column
    tile, rank, row tile) the rank's K range in blocks of kblk rows (zeros
    past K, N and M).  FFMA (``mm_float``): each consumer thread (quad q of
    4 columns, way) sums the block's K rows 4 * k4 .. 4 * k4 + 3 for k4 =
    way, way + ways, ...; the ways' and warps' shares added.  Tensor cores
    (``mm_float_tc``): each of 8 warps (a column group of 16, share s of
    the group's SHARES warps) takes the block's units of 32 rows u = s, s
    + SHARES, ... up to the last that holds a row of the range, adding each
    k16 half's products into its own sum (``tf32``: two k8 steps, a lane's
    even K rows then its odd ones), the two sums added, then the shares in
    order; ``split`` (an f32 x): x's three parts (:func:`_split3`) in
    turn, each over the half's steps, x0's products into the half's sum
    and x1's then x2's into a low sum of its own, the halves' low sums
    added after the halves' sums.
    The ranks' sums are added in order."""
    M, K = x.shape
    N = w.shape[1]
    out = np.zeros((M, N), np.float32)
    unit = MM_FLOAT_TC_UNIT
    shares = mm_float_shares(plan.tn, True)
    ways = MM_FLOAT_CONSUMERS // (plan.tn // 4)
    for nt in range(plan.n_tiles):
        n0 = nt * plan.tn
        n_ok = min(plan.tn, N - n0)
        for mt in range(plan.m_tiles):
            m0 = mt * MM_TM
            rows = min(MM_TM, M - m0)
            total = np.zeros((MM_TM, plan.tn), np.float32)
            for rank in range(plan.split):
                k0 = min(K, rank * plan.kr)
                k1 = min(K, k0 + plan.kr)
                if plan.tensor_cores:
                    acc = np.zeros((shares, 2, 2, MM_TM, plan.tn),
                                   np.float32)
                else:
                    share = np.zeros((ways, MM_TM, plan.tn), np.float32)
                for kbase in range(k0, k1, plan.kblk):
                    ws, xs, n_rows = _tile_operands(plan, x, w, nt, mt, k1,
                                                    kbase)
                    parts = ([_value32(p) for p in _split3(xs)] if split
                             else [xs])
                    if not plan.tensor_cores:
                        for k4 in range(-(-n_rows // 4)):
                            way = k4 % ways
                            for e in range(4 * k4, 4 * k4 + 4):
                                share[way] += np.outer(xs[:, e], ws[e])
                        continue
                    for u in range(-(-n_rows // unit)):
                        for j in range(2):
                            r0 = u * unit + 16 * j
                            steps = ([range(r0, r0 + 16, 2),
                                      range(r0 + 1, r0 + 16, 2)] if tf32
                                     else [range(r0, r0 + 16)])
                            for q, xq in enumerate(parts):
                                for ks in steps:
                                    ks = list(ks)
                                    acc[u % shares, min(q, 1), j] += (
                                        xq[:, ks].astype(np.float64)
                                        @ ws[ks].astype(np.float64)
                                    ).astype(np.float32)
                if plan.tensor_cores:
                    red = acc[:, 0, 0] + acc[:, 0, 1]
                    if split:
                        red += acc[:, 1, 0] + acc[:, 1, 1]
                    cta = red[0].copy()
                    for s_ in range(1, shares):
                        cta += red[s_]
                else:
                    cta = share.sum(axis=0, dtype=np.float32)
                total += cta
            out[m0:m0 + rows, n0:n0 + n_ok] = total[:rows, :n_ok]
    return out


# (M, K, N, mode, bk, n_buffers, sm_count): a ragged shape (three row
# tiles, a ragged K split and N tile), a stream ring of several blocks, a
# fifo ring of one slot on one SM's plan, and a pinned split; then the
# same paths for the tensor-core plans (K blocks of 32 rows and more):
# ragged, four warps a column group sharing a block's units (32 columns),
# a stream ring of 64-column tiles (two warps a group), a one-slot ring of
# three blocks of a 128-column tile (a warp a group), and a pinned split
# of two units a rank
EMU = [(17, 100, 36, "fifo", 16, 3, 132), (8, 256, 64, "stream", 16, 2, 132),
       (8, 96, 48, "fifo", 16, 1, 1), (16, 512, 32, "pinned", 512, 2, 132),
       (17, 300, 36, "fifo", 64, 3, 132), (8, 1024, 128, "stream", 32, 2, 16),
       (8, 96, 48, "fifo", 16, 1, 1), (16, 512, 32, "pinned", 512, 2, 132)]
EMU_IDS = ["m{}-k{}-n{}-{}-bk{}-nb{}-sm{}".format(*c) for c in EMU]
# the FFMA cases' ids as they were; the tensor-core cases after them
EMU_IDS = EMU_IDS[:4] + [i + "-tc" for i in EMU_IDS[4:]]


@pytest.mark.parametrize("xd,wd", PAIRS)
@pytest.mark.parametrize("case", EMU, ids=EMU_IDS)
def test_emulated_float_matmul_matches_reference_and_pallas(case, xd, wd):
    M, K, N, mode, bk, nb, sms = case
    rng = np.random.default_rng(M * K + N)
    x, w, tx, tw = _operands(rng, (M, K, N), xd, wd)
    plan = mm_float_plan(M, K, N, mode, bk, nb, BYTES[xd], BYTES[wd], sms)
    got = _emulate(tx.float().numpy(), tw.float().numpy(), plan,
                   split=plan.tensor_cores and xd == "f32")
    out_dtype = result_dtype(tx.dtype, tw.dtype)
    got = torch.from_numpy(got).to(out_dtype).float().numpy()
    want = stream_matmul_ref(tx, tw).float().numpy()
    tol = _tol(out_dtype)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))
    if M % 8 == 0 and K % 16 == 0 and N % 16 == 0:
        pallas = np.asarray(jax_matmul(x, w, mode=mode, bm=8, bk=16, bn=16,
                                       n_buffers=nb, interpret=True),
                            np.float32)
        np.testing.assert_allclose(got, pallas, rtol=tol,
                                   atol=tol * float(np.abs(pallas).max()))


def test_emulated_cases_take_the_plan_paths_they_name():
    plans = [mm_float_plan(*c[:6], 4, 4, c[6]) for c in EMU[:4]]
    assert not any(p.tensor_cores for p in plans)
    assert plans[0].m_tiles == 3 and plans[0].split > 1
    assert plans[0].split * plans[0].kr > 100
    assert plans[1].kr > plans[1].kblk and plans[1].nb == 2
    assert (plans[2].nb, plans[2].split) == (1, 1)
    assert plans[2].kr > plans[2].kblk
    assert plans[3].split > 1 and plans[3].kblk == plans[3].kr
    tc = [mm_float_plan(*c[:6], 2, 2, c[6]) for c in EMU[4:]]
    assert all(p.tensor_cores and p.kr % MM_FLOAT_TC_UNIT == 0 for p in tc)
    # ragged M, N and K split; 32 columns: four warps a group, the first
    # block of two units
    assert tc[0].m_tiles == 3 and tc[0].split > 1 and tc[0].tn == 32
    assert tc[0].split * tc[0].kr > 300 and tc[0].kblk == 2 * 32
    assert tc[0].kr > tc[0].kblk and tc[0].nb == 2
    assert tc[1].tn == 64 and tc[1].kr > tc[1].kblk and tc[1].nb == 2
    assert (tc[2].nb, tc[2].split) == (1, 1) and tc[2].kr == 3 * tc[2].kblk
    assert tc[2].tn == 128
    assert tc[3].split > 1 and tc[3].kblk == tc[3].kr == 2 * 32
    assert tc[3].tn == 32


ALL_TYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
             "f16": torch.float16, "int8": torch.int8}
ALL_PAIRS = [(a, b) for a in ALL_TYPES for b in ALL_TYPES
             if (a, b) != ("int8", "int8")]
ALL_BYTES = {"f32": 4, "bf16": 2, "f16": 2, "int8": 1}


def _tf32(xd, wd):
    """Whether the pair's tensor-core products run m16n8k8 tf32 (the .cu's
    ``MmaType``): bf16 with f16, and an f32 x's parts against f16."""
    return {xd, wd} == {"bf16", "f16"} or (xd, wd) == ("f32", "f16")


def _typed(rng, shape, name):
    """Normal values rounded to the type, or int8 integers in [-127, 127],
    as a torch tensor of the type."""
    if name == "int8":
        return torch.from_numpy(rng.integers(-127, 128, size=shape)
                                .astype(np.int8))
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        ALL_TYPES[name])


@pytest.mark.parametrize("xd,wd", ALL_PAIRS)
@pytest.mark.parametrize("case", EMU[4:], ids=EMU_IDS[4:])
def test_emulated_every_pair_matches_reference(case, xd, wd):
    """Every pair's body (the tensor cores for the eleven with bf16, f16
    or int8 weights, FFMA for the four with f32 weights), emulated with
    its own plan in its order of sums, within the output type's limit of
    the plain version."""
    M, K, N, mode, bk, nb, sms = case
    rng = np.random.default_rng(M * K + N + len(xd) * 7 + len(wd))
    tx, tw = _typed(rng, (M, K), xd), _typed(rng, (K, N), wd)
    plan = mm_float_plan(M, K, N, mode, bk, nb, ALL_BYTES[xd],
                         ALL_BYTES[wd], sms)
    assert plan.tensor_cores == (wd != "f32")
    got = _emulate(tx.float().numpy(), tw.float().numpy(), plan,
                   tf32=_tf32(xd, wd), split=xd == "f32" and wd != "f32")
    out_dtype = result_dtype(tx.dtype, tw.dtype)
    got = torch.from_numpy(got).to(out_dtype).float().numpy()
    want = stream_matmul_ref(tx, tw).float().numpy()
    tol = _tol(out_dtype) if out_dtype != torch.float16 else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def test_tensor_cores_take_the_pairs_without_f32():
    """The pairs without f32 weights: the eight without f32 and f32 x
    against bf16, f16 and int8 weights; FFMA keeps the four f32-weight
    pairs."""
    got = {(a, b) for a, b in ALL_PAIRS
           if mm_float_tensor_cores(ALL_BYTES[a], ALL_BYTES[b])}
    assert len(got) == 11 and all(b != "f32" for _, b in got)
    assert set(ALL_PAIRS) - got == {(a, "f32") for a in ALL_TYPES}
    assert not mm_float_tensor_cores(1, 1)


def test_float_instance_names_the_body_each_pair_launches():
    for a, b in ALL_PAIRS:
        body = ("mm_float_tc" if mm_float_tensor_cores(ALL_BYTES[a],
                                                       ALL_BYTES[b])
                else "mm_float")
        for tn in (32, 64, 128):
            assert float_instance(ALL_TYPES[a], ALL_TYPES[b], tn) == \
                f"{body}<{a},{b},{tn}>"


# ---------------------------------------------------------------------------
# the split of an f32 x into three bf16 parts
# ---------------------------------------------------------------------------

def _split3(x):
    """stream_matmul.cu::split3 on f32 values: three uint32 arrays of f32
    bit patterns whose low 16 bits are zero (bf16 values), x0 the bits of
    x truncated to their high half, x1 the remainder x - x0 (exact in
    f32) truncated the same way, x2 = (x - x0) - x1 truncated; a
    non-finite x gives x0 = x (a NaN the quiet NaN) and x1 = x2 = 0."""
    x = np.ascontiguousarray(x, np.float32)
    v = x.view(np.uint32)
    hi = v & np.uint32(0xffff0000)
    with np.errstate(invalid="ignore", over="ignore"):
        r = x - hi.view(np.float32)
        mid = r.view(np.uint32) & np.uint32(0xffff0000)
        lo = (r - mid.view(np.float32)).view(np.uint32) \
            & np.uint32(0xffff0000)
    finite = (v & np.uint32(0x7f800000)) != np.uint32(0x7f800000)
    nan = ~finite & ((v & np.uint32(0x007fffff)) != 0)
    zero = np.uint32(0)
    return (np.where(nan, np.uint32(0x7fc00000), hi),
            np.where(finite, mid, zero), np.where(finite, lo, zero))


def _value32(bits):
    """uint32 f32 bit patterns as f32 values."""
    return np.ascontiguousarray(bits, np.uint32).view(np.float32)


def _full_significands(rng, exps):
    """f32 values of random sign and 24-bit significands (the last bit and
    bit 15 set, so every part of the split is non-zero) in binades
    ``exps``."""
    m = rng.integers(1 << 23, 1 << 24, size=len(exps)) | 0x8001
    sign = rng.choice([-1.0, 1.0], size=len(exps))
    return (sign * np.ldexp(m.astype(np.float64), np.asarray(exps) - 23)
            ).astype(np.float32)


F32_MAX = float(np.finfo(np.float32).max)
BF16_MAX = float(np.array([0x7f7f0000], np.uint32).view(np.float32)[0])
# finite edge values: +-0, the largest finite f32, values above bf16's
# largest (round to nearest makes those from 0x7f7f8000 on inf), the
# smallest normal and 2^-110, where the exact range begins
SPLIT_EDGES = np.concatenate([
    np.array([0.0, -0.0, F32_MAX, -F32_MAX, BF16_MAX, 2.0 ** -126,
              -(2.0 ** -126), 2.0 ** -110, 2.0 ** -110 * (1 + 2.0 ** -23),
              1.0, -1.5], np.float32),
    np.array([0x7f7f0001, 0x7f7f8000, 0xff7fffff], np.uint32).view(
        np.float32)])


def test_split3_is_exact_from_2_to_the_minus_110():
    """Every binade from 2^-110 to the largest, 24-bit significands, and
    the finite edges: x0 + x1 + x2 == x exactly, each part a bf16 value
    (its low 16 bits zero), x0 never rounded up (finite above bf16's
    largest), every part non-zero for the full significands."""
    rng = np.random.default_rng(31)
    exps = np.repeat(np.arange(-110, 128), 8)
    x = np.concatenate([_full_significands(rng, exps), SPLIT_EDGES])
    x = x[(np.abs(x) >= 2.0 ** -110) | (x == 0)]
    parts = _split3(x)
    for p in parts:
        assert not (p & np.uint32(0xffff)).any()
        assert np.isfinite(_value32(p)).all()
    total = sum(_value32(p).astype(np.float64) for p in parts)
    np.testing.assert_array_equal(total, x.astype(np.float64))
    full = len(exps)
    assert all((p[:full] != 0).all() for p in parts)
    # bf16's round to nearest makes these inf (from bf16's largest plus
    # half its last place, 0x7f7f8000)
    rn_inf = (x.view(np.uint32) & np.uint32(0x7fffffff)) >= 0x7f7f8000
    assert rn_inf.sum() == 4
    assert np.isinf(torch.from_numpy(x[rn_inf]).to(torch.bfloat16)
                    .float().numpy()).all()


def test_split3_below_2_to_the_minus_110_is_within_2_to_the_minus_133():
    """Below 2^-110 (the smallest normal, subnormals) the last part's bits
    under bf16's least subnormal, 2^-133, are dropped: the sum is within
    2^-133 of x, and inexact where x has such bits."""
    rng = np.random.default_rng(32)
    exps = np.repeat(np.arange(-149, -110), 8)
    x = np.concatenate([_full_significands(rng, exps).astype(np.float64),
                        np.ldexp(1.0, np.arange(-149, -110)),
                        [2.0 ** -149 * 3, -(2.0 ** -126)]]).astype(np.float32)
    assert (np.abs(x) < 2.0 ** -110).all() and (x != 0).all()
    parts = _split3(x)
    err = np.abs(sum(_value32(p).astype(np.float64) for p in parts)
                 - x.astype(np.float64))
    assert (err < 2.0 ** -133).all()
    assert (err > 0).sum() >= len(exps) // 2
    # the edge of the range: 2^-111 (1 + 2^-23) has a last bit of 2^-134
    edge = np.float32(2.0 ** -111 * (1 + 2.0 ** -23))
    assert sum(float(_value32(p)[0]) for p in _split3(np.array([edge]))) \
        != float(edge)


def test_split3_carries_inf_and_nan_in_the_first_part():
    """A non-finite x: x0 is x (+-inf) or a NaN, whatever bits the NaN's
    payload has (only low ones: truncating would make it inf), x1 = x2 =
    0; so inf and NaN reach the sums as the plain version's do."""
    bits = np.array([0x7f800000, 0xff800000, 0x7f800001, 0xff80ffff,
                     0x7fc00000, 0xffffffff, 0x7f810000], np.uint32)
    x0, x1, x2 = _split3(bits.view(np.float32))
    v0 = _value32(x0)
    assert (v0[:2] == [np.inf, -np.inf]).all()
    assert np.isnan(v0[2:]).all()
    assert not x1.any() and not x2.any()


# ---------------------------------------------------------------------------
# the tensor-core body's fragments, lane by lane
# ---------------------------------------------------------------------------

def _u16(buf, at):
    return int(buf[at]) | int(buf[at + 1]) << 8


def _ldsm(buf, addrs, trans):
    """ldmatrix .x4 of b16 elements: lane 8i + r gives the address of row
    r of matrix i.  Per lane (g = lane / 4, t = lane % 4) four 32-bit
    registers: of matrix i, row g's elements 2t, 2t + 1 (``trans``: row
    2t's and row 2t + 1's element g), the first in the low half."""
    regs = []
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        row = []
        for i in range(4):
            if trans:
                lo = _u16(buf, addrs[8 * i + 2 * t] + 2 * g)
                hi = _u16(buf, addrs[8 * i + 2 * t + 1] + 2 * g)
            else:
                lo = _u16(buf, addrs[8 * i + g] + 4 * t)
                hi = _u16(buf, addrs[8 * i + g] + 4 * t + 2)
            row.append(lo | hi << 16)
        regs.append(row)
    return regs


def _value(bits, name):
    """A 16-bit pattern of bf16 or f16 as a float."""
    if name == "bf16":
        return float(np.array([bits << 16], np.uint32).view(np.float32)[0])
    return float(np.array([bits], np.uint16).view(np.float16)[0])


def _halves(reg, name):
    """A register's two 16-bit values (low, high) as floats."""
    return _value(reg & 0xffff, name), _value(reg >> 16, name)


def _widen_i8x2(v, name):
    """stream_matmul.cu::widen_i8x2: the int8 values in the low bytes of
    the halves of v, as the magic with the low 7 bits as mantissa less the
    magic with the sign bit; the two values (low, high) as floats."""
    magic = 0x43004300 if name == "bf16" else 0x64006400
    low, sign = (v & 0x007f007f) | magic, (v & 0x00800080) | magic
    a, b = _halves(low, name), _halves(sign, name)
    return a[0] - b[0], a[1] - b[1]


def _unit_row(xl, j, h, r):
    """stream_matmul.cu::unit_row for x's layout ``xl``: 16-bit values
    (``x16``), int8 words (``x8``) or f32 values split in registers
    (``x32``)."""
    if xl == "x8":
        return 16 * j + 4 * (r >> 1) + 2 * (r & 1) + h
    if xl == "x16":
        return 16 * j + 8 * h + r
    return 16 * j + 8 * h + (r >> 1) + 4 * (r & 1)


def _tile_at(tma, r, b, pitch, box_rows):
    """stream_matmul.cu::tile_at: byte b of row r of a slot's tile, padded
    rows of ``pitch`` bytes, or TMA boxes of ``box_rows`` rows of 128
    bytes whose 16-byte chunks the 128-byte swizzle puts at chunk ^ (r %
    8) (CUTLASS's Swizzle<3, 4, 3> of a 1024-byte aligned box)."""
    if not tma:
        return r * pitch + b
    return ((b >> 7) * (box_rows << 7) + (r << 7)
            + ((((b >> 4) & 7) ^ (r & 7)) << 4) + (b & 15))


def _mma(a, b, tf32):
    """mma.sync m16n8k16 (``tf32``: m16n8k8) on per-lane fragments of
    values (a: 4 registers, b: 2, each a (low, high) pair, or one tf32
    value) -> D[16][8].  A[row][k] is in lane (row % 8, k-in-lane) as PTX
    lays the fragments out."""
    d = np.zeros((16, 8))
    for row in range(16):
        for col in range(8):
            for k in range(8 if tf32 else 16):
                if tf32:
                    av = a[(row % 8) * 4 + k % 4][(row >= 8) + 2 * (k >= 4)]
                    bv = b[col * 4 + k % 4][int(k >= 4)]
                else:
                    t = (k % 8) // 2
                    av = a[(row % 8) * 4 + t][(row >= 8) + 2 * (k >= 8)][
                        k % 2]
                    bv = b[col * 4 + t][int(k >= 8)][k % 2]
                d[row, col] += av * bv
    return d


def _bits(values, name):
    """Little-endian bytes of values in the type: f32, bf16, f16 or
    int8."""
    if name == "f32":
        return values.astype(np.float32).view(np.uint8).reshape(-1)
    if name == "int8":
        return values.astype(np.int8).view(np.uint8).reshape(-1)
    if name == "f16":
        return values.astype(np.float16).view(np.uint8).reshape(-1)
    return (values.astype(np.float32).view(np.uint32) >> 16).astype(
        np.uint16).view(np.uint8).reshape(-1)


def _split_slot(xbuf, tma, xrow, kblk):
    """mm_float_tc's split of a slot's f32 x: for i over MM_TM * kblk / 2,
    row m = i / (kblk / 2), K rows k, k + 1 (k = 2 (i % (kblk / 2))) read
    as 8 bytes at ``tile_at`` and split (:func:`_split3`), the two values'
    part q written as a bf16 pair at row m, byte 2k of part q's rows of
    2 kblk + 16 bytes.  Returns the three parts' bytes."""
    prow = 2 * kblk + 16
    parts = [np.zeros(MM_TM * prow, np.uint8) for _ in range(3)]
    pairs = kblk // 2
    for i in range(MM_TM * pairs):
        m, k = i // pairs, 2 * (i % pairs)
        at = _tile_at(tma, m, 4 * k, xrow, MM_TM)
        v = xbuf[at:at + 8].copy().view(np.float32)
        for q, p in enumerate(_split3(v)):
            word = (int(p[0]) >> 16) | (int(p[1]) & 0xffff0000)
            parts[q][m * prow + 2 * k:m * prow + 2 * k + 4] = np.array(
                [word], np.uint32).view(np.uint8)
    return parts


TC_PAIRS = [(a, b) for a, b in ALL_PAIRS if b != "f32"]
# (x, w, tn, route): every tensor-core pair at every tile on the cp.async
# route's padded rows, and on the TMA route's swizzled boxes where the
# tile is one or two 128-byte boxes
FRAGMENT_CASES = [(xd, wd, tn, tma) for xd, wd in TC_PAIRS
                  for tn in (32, 64, 128) for tma in (False, True)
                  if not tma or tn * ALL_BYTES[wd] in (128, 256)]


@pytest.mark.parametrize("xd,wd,tn,tma", FRAGMENT_CASES, ids=[
    "{}-{}-{}-{}".format(xd, wd, tn, "tma" if tma else "cp")
    for xd, wd, tn, tma in FRAGMENT_CASES])
def test_tensor_core_fragments_compute_the_tile_product(xd, wd, tn, tma):
    """One unit (32 K rows) of a slot through ``mm_float_tc``'s consumer
    arithmetic, modelled lane by lane: the ldmatrix addresses (``w_at``,
    the x rows, ``unit_row``, ``tile_at`` on either route), the int8
    widening, an f32 x's split (at 64 and 128 columns a slot's x read two
    values at a time into the three bf16 parts' padded rows, which the
    fragments read as a bf16 x's; at 32 x's f32 rows read by ldmatrix and
    split in each lane; each part's products on the same A fragments, x0's
    summed apart),
    the tf32 steps and the epilogue's columns, in every column group of a
    ``tn`` tile, equal the exact product of the unit's rows (small
    integers, or f32 x of 24 significant bits in a few binades, so every
    sum is exact)."""
    rng = np.random.default_rng(len(xd) * 10 + len(wd) + tn)
    xi8, xf32, wi8 = xd == "int8", xd == "f32", wd == "int8"
    xl = "x8" if xi8 else "x32" if xf32 and tn == 32 else "x16"
    tf32 = _tf32(xd, wd)
    mt = wd if xi8 else "bf16" if xf32 else xd
    lim = 127 if (xi8 or wi8) else 16
    x = rng.integers(-lim, lim + 1, size=(MM_TM, 32)).astype(np.float64)
    if xf32:
        x = _full_significands(rng, rng.integers(0, 5, size=MM_TM * 32)
                               ).reshape(MM_TM, 32).astype(np.float64)
    w = rng.integers(-lim, lim + 1, size=(32, tn)).astype(np.float64)
    xb, wb = ALL_BYTES[xd], ALL_BYTES[wd]
    # mm_float_layout of a one-unit block (kblk = 32)
    srow = tn * wb + (0 if tma else 16)
    xrow = 128 if tma else 32 * xb + 16
    wbuf = rng.integers(0, 256, size=32 * max(srow, 128)).astype(np.uint8)
    xbuf = rng.integers(0, 256, size=MM_TM * xrow).astype(np.uint8)
    for k in range(32):
        for b, v in enumerate(_bits(w[k], wd)):
            wbuf[_tile_at(tma, k, b, srow, 32)] = v
    for m in range(MM_TM):
        for b, v in enumerate(_bits(x[m], xd)):
            xbuf[_tile_at(tma, m, b, xrow, MM_TM)] = v
    out = np.full((MM_TM, tn), np.nan)
    for grp in range(tn // 16):
        # B fragments (j, h) at 2j + h, one set a part of x
        if xl == "x32":
            # ldmatrix of x's 16-byte rows as b16 pairs, half j's matrix i
            # the K rows 16j + 4i .. + 3 (lane t: 16j + 4i + t), each f32
            # split in three and packed as bf16 pairs
            raw = np.array([_ldsm(xbuf, [_tile_at(
                tma, L & 7, (16 * j + 4 * (L >> 3)) * 4, xrow, MM_TM)
                for L in range(32)], trans=False) for j in range(2)],
                np.uint32)
            parts = [_value32(p).astype(np.float64)
                     for p in _split3(raw.view(np.float32))]
            bs = [[[(p[j, L, 2 * h], p[j, L, 2 * h + 1])
                    for j in range(2) for h in range(2)]
                   for L in range(32)] for p in parts]
        elif xf32:
            # the slot's x split into the parts' rows (mm_float_parts, a
            # one-unit block), each part's fragments by ldmatrix as bf16 x's
            bs = []
            for q, pbuf in enumerate(_split_slot(xbuf, tma, xrow, 32)):
                raw = _ldsm(pbuf, [(L & 7) * (2 * 32 + 16) + 16 * (L >> 3)
                                   for L in range(32)], trans=False)
                bs.append([[_halves(r, "bf16") for r in lane]
                           for lane in raw])
        elif xi8:
            b = []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                regs = []
                for j in range(2):
                    at = _tile_at(tma, g, 16 * j + 4 * t, xrow, MM_TM)
                    v = int(xbuf[at:at + 4].view(np.uint32)[0])
                    regs += [_widen_i8x2(v, mt), _widen_i8x2(v >> 8, mt)]
                b.append(regs)
        else:
            raw = _ldsm(xbuf, [_tile_at(tma, L & 7, 16 * (L >> 3), xrow, MM_TM)
                               for L in range(32)], trans=False)
            b = [[_halves(r, xd) for r in lane] for lane in raw]
        if not xf32:
            bs = [b]
        # A fragments of the halves j
        af = [[None] * 32 for _ in range(2)]
        if wi8:
            raw = _ldsm(wbuf, [_tile_at(tma, _unit_row(
                xl, (L >> 3) >> 1, (L >> 3) & 1, L & 7), grp * 16, srow, 32)
                for L in range(32)], trans=True)
            for lane in range(32):
                v = raw[lane]
                for j in range(2):
                    af[j][lane] = [_widen_i8x2(v[2 * j], mt),
                                   _widen_i8x2(v[2 * j] >> 8, mt),
                                   _widen_i8x2(v[2 * j + 1], mt),
                                   _widen_i8x2(v[2 * j + 1] >> 8, mt)]
        else:
            for j in range(2):
                # half 1's rows 16 rows (half a unit) after half 0's
                raw = _ldsm(wbuf, [_tile_at(
                    tma, _unit_row(xl, 0, (L >> 3) >> 1, L & 7),
                    (grp * 16 + ((L >> 3) & 1) * 8) * 2, srow, 32)
                    + j * 16 * (128 if tma else srow)
                    for L in range(32)], trans=True)
                for lane in range(32):
                    af[j][lane] = [_halves(r, wd) for r in raw[lane]]
        acc = np.zeros((2, 2, 16, 8))   # (x0's or the low parts', half)
        for j in range(2):
            for q, b in enumerate(bs):
                if tf32:
                    for h in range(2):
                        at = [[af[j][L][2 * h][0], af[j][L][2 * h + 1][0],
                               af[j][L][2 * h][1], af[j][L][2 * h + 1][1]]
                              for L in range(32)]
                        bt = [list(b[L][2 * j + h]) for L in range(32)]
                        acc[min(q, 1), j] += _mma(at, bt, tf32=True)
                else:
                    acc[min(q, 1), j] += _mma(
                        af[j], [[b[L][2 * j], b[L][2 * j + 1]]
                                for L in range(32)], tf32=False)
        d = (acc[0, 0] + acc[0, 1]) + (acc[1, 0] + acc[1, 1])
        # the epilogue: lane (g, t) holds D[g][2t], [g][2t + 1], [g + 8][2t],
        # [g + 8][2t + 1]; mma row i is column grp * 16 + i (int8 w: 2i,
        # and 2(i - 8) + 1)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            lo = grp * 16 + (2 * g if wi8 else g)
            hi = grp * 16 + (2 * g + 1 if wi8 else g + 8)
            for m in (2 * t, 2 * t + 1):
                assert np.isnan(out[m, lo]) and np.isnan(out[m, hi])
                out[m, lo], out[m, hi] = d[g, m], d[g + 8, m]
    np.testing.assert_array_equal(out, x @ w)
