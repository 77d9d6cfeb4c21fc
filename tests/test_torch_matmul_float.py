"""The float modes of the streamed matmul (K7/K8 with f32 or bf16
operands) on the CPU.

The port's ``stream_matmul`` against the JAX package's Pallas kernels in
interpret mode, for every operand pair of f32 and bf16 in all three
modes: the same result type (bf16 for bf16 x bf16, f32 otherwise) and
values within ``tests/test_kernels.py``'s limits.  Then the launch plan
of the CUDA kernel (``stream_matmul/ops.py::mm_float_plan``, mirrored by
``csrc/stream_matmul.cu::mm_float_layout``) at the JAX tests' shapes, a
ragged one and every fc head of the six CNN configs: the CTAs' K ranges
tile K exactly, the ring's depth is ``ring()``'s, shared memory fits a
block; the ring's waits and arrivals replayed in Python obey the credit
rule; and an f32 emulation of what the kernel computes with its plan
against the plain version and the JAX kernel.
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
                                                   MM_FLOAT_CONSUMERS,
                                                   MM_FLOAT_KBLK,
                                                   MM_MAX_SPLIT,
                                                   MM_SLOT_MAX, MM_TILES,
                                                   MM_TM, mm_float_layout,
                                                   mm_float_plan,
                                                   mm_float_slot, ring,
                                                   stream_matmul)
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
        assert plan.tn in MM_TILES and len(_ranges(N, plan.tn)) == \
            plan.n_tiles
        assert plan.m_tiles == -(-M // MM_TM)
        assert plan.split in (1, 2, 4, 8) and plan.split <= MM_MAX_SPLIT
        assert plan.kr % 16 == 0
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
            assert plan.kblk % MM_FLOAT_KBLK == 0
            assert plan.kblk <= max(MM_FLOAT_KBLK, blk)
            assert mm_float_slot(plan.tn, plan.kblk, xb, wb) <= MM_SLOT_MAX
            for lo, hi in ranges:
                blocks = _ranges(hi - lo, plan.kblk)
                assert blocks[-1][1] == hi - lo
            assert plan.nb == min(depth, -(-plan.kr // plan.kblk))
        # copies: 16 bytes where the rows allow, else 8, 4 or one bf16
        for vec, row, es in ((plan.wvec, N * wb, wb),
                             (plan.xvec, K * xb, xb)):
            assert row % vec == 0
            assert vec == next(v for v in (16, 8, 4, es) if row % v == 0)
        assert plan.smem_bytes == mm_float_layout(
            plan.tn, plan.kblk, plan.nb, xb, wb) <= MAX_SMEM_BYTES


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


def _emulate(x, w, plan):
    """What ``mm_float`` computes with ``plan``, in f32: per CTA (column
    tile, rank, row tile) the rank's K range in blocks of kblk rows (zeros
    past K, N and M), each consumer thread (quad q of 4 columns, way) summing
    the block's K rows 4 * k4 .. 4 * k4 + 3 for k4 = way, way + ways, ...;
    the ways' and warps' shares added, then the ranks' sums in order."""
    M, K = x.shape
    N = w.shape[1]
    ways = MM_FLOAT_CONSUMERS // (plan.tn // 4)
    out = np.zeros((M, N), np.float32)
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
                share = np.zeros((ways, MM_TM, plan.tn), np.float32)
                for kbase in range(k0, k1, plan.kblk):
                    hi = min(k1, kbase + plan.kblk)
                    ws = np.zeros((plan.kblk, plan.tn), np.float32)
                    ws[:hi - kbase, :n_ok] = w[kbase:hi, n0:n0 + n_ok]
                    xs = np.zeros((MM_TM, plan.kblk), np.float32)
                    xs[:rows, :hi - kbase] = x[m0:m0 + rows, kbase:hi]
                    for k4 in range(-(-(hi - kbase) // 4)):
                        way = k4 % ways
                        for e in range(4 * k4, 4 * k4 + 4):
                            share[way] += np.outer(xs[:, e], ws[e])
                total += share.sum(axis=0, dtype=np.float32)
            out[m0:m0 + rows, n0:n0 + n_ok] = total[:rows, :n_ok]
    return out


# (M, K, N, mode, bk, n_buffers, sm_count): a ragged shape (three row
# tiles, a ragged K split and N tile), a stream ring of several blocks, a
# fifo ring of one slot on one SM's plan, and a pinned split
EMU = [(17, 100, 36, "fifo", 16, 3, 132), (8, 256, 64, "stream", 16, 2, 132),
       (8, 96, 48, "fifo", 16, 1, 1), (16, 512, 32, "pinned", 512, 2, 132)]


@pytest.mark.parametrize("xd,wd", PAIRS)
@pytest.mark.parametrize("case", EMU, ids=[
    "m{}-k{}-n{}-{}-bk{}-nb{}-sm{}".format(*c) for c in EMU])
def test_emulated_float_matmul_matches_reference_and_pallas(case, xd, wd):
    M, K, N, mode, bk, nb, sms = case
    rng = np.random.default_rng(M * K + N)
    x, w, tx, tw = _operands(rng, (M, K, N), xd, wd)
    plan = mm_float_plan(M, K, N, mode, bk, nb, BYTES[xd], BYTES[wd], sms)
    got = _emulate(tx.float().numpy(), tw.float().numpy(), plan)
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
    plans = [mm_float_plan(*c[:6], 4, 4, c[6]) for c in EMU]
    assert plans[0].m_tiles == 3 and plans[0].split > 1
    assert plans[0].split * plans[0].kr > 100
    assert plans[1].kr > plans[1].kblk and plans[1].nb == 2
    assert (plans[2].nb, plans[2].split) == (1, 1)
    assert plans[2].kr > plans[2].kblk
    assert plans[3].split > 1 and plans[3].kblk == plans[3].kr
