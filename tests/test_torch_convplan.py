"""The pinned dense conv's launch plan (``conv2d_int8/ops.py::conv_plan``,
mirrored by ``csrc/conv2d_int8.cu::layout``) at every pinned dense conv
shape (K1) of every CNN config, at batch 1 and 8: one CTA's shared memory
fits an H100 block and matches its layout, the plan's ``conv_mma``
instance computes its C_out tile, the CTAs cover every output
row and channel once, and the ring holds every row two consecutive chunks
read.  Then a plain int64 emulation of what the kernel does with the plan
(the line-buffer ring with its slots and stride phases, the weights as
K-contiguous rows, the packed stem's (k_h, k_w, C) patches) against
``conv2d_int8_ref`` and the JAX kernel in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d_int8.ops import conv2d_int8 as jax_conv
from repro_torch.compiler import MINI, NX2100, compile, select_engine
from repro_torch.configs import cnn
from repro_torch.kernels.conv2d_int8.ops import (CONV_INSTANCES, CONV_MT,
                                                 CONV_NTILES, MAX_SMEM_BYTES,
                                                 conv_layout, conv_packed,
                                                 conv_plan, stem_k_index)
from repro_torch.kernels.conv2d_int8.ref import (conv2d_int8_ref,
                                                 same_out_and_pad)


def _k1_shapes():
    """(h, w, C, C_out, k_h, k_w, stride) of every pinned dense conv of the
    six CNN configs compiled for NX2100 and the three mini nets for MINI."""
    nets = [(cfg, NX2100) for cfg in cnn.CNN_CONFIGS.values()] + [
        (getattr(cnn, n)(), MINI)
        for n in ("mini_resnet18", "mini_resnet50", "mini_mobilenet")]
    shapes = set()
    for cfg, target in nets:
        for s in compile(cfg, target).plan.schedules:
            sp = s.spec
            if select_engine(sp).name == "conv2d_int8" and not s.streamed:
                shapes.add((sp.in_h, sp.in_w, sp.c_in, sp.c_out, sp.k_h,
                            sp.k_w, sp.stride))
    return sorted(shapes)


K1_SHAPES = _k1_shapes()
CASES = [(shape, batch) for shape in K1_SHAPES for batch in (1, 8)]


def test_k1_shapes_cover_the_stems_and_every_kernel_size():
    assert len(K1_SHAPES) >= 60
    assert {s[4] for s in K1_SHAPES} == {1, 3, 7}
    stems = [s for s in K1_SHAPES if conv_packed(s[2])]
    assert {(s[2], s[4], s[6]) for s in stems} >= {(3, 7, 2), (3, 3, 2)}


def ring_row_of(u, stride, k_h):
    """The ring row that keeps the band's input row ``u`` (0 at the band's
    first; csrc: ring_input_row inverts it), or None where no output reads
    it (``u % stride >= k_h``)."""
    rs = min(stride, k_h)
    return None if u % stride >= rs else u // stride * rs + u % stride


def _chunk_rows(plan, h_out, w_out, k_h, stride):
    """Per band, per chunk: the ring rows [lo, hi) the chunk's pixels read
    (csrc: ring_rows_upto in conv_mma), checked against ring_row_of."""
    rs = min(stride, k_h)
    for band in range(plan.bands):
        r0 = band * plan.rows_per_band
        p = (min(h_out, r0 + plan.rows_per_band) - r0) * w_out
        chunks = []
        for q in range(-(-p // CONV_MT)):
            first = q * CONV_MT // w_out
            last = (min(p, (q + 1) * CONV_MT) - 1) // w_out
            read = {ring_row_of(r * stride + i, stride, k_h)
                    for r in range(first, last + 1) for i in range(k_h)}
            assert None not in read
            chunks.append((first * rs, last * rs + k_h))
            assert read == set(range(*chunks[-1]))
        yield chunks


@pytest.mark.parametrize("case", CASES, ids=[
    "{}x{}x{}-{}-k{}x{}s{}-b{}".format(*s, b) for s, b in CASES])
def test_conv_plan_covers_and_fits(case):
    (h, w, c, co, k_h, k_w, s), batch = case
    plan = conv_plan(batch, h, w, c, co, k_h, k_w, s)
    h_out, _ = same_out_and_pad(h, k_h, s)
    w_out, _ = same_out_and_pad(w, k_w, s)
    # every output row once
    rows = [r for band in range(plan.bands)
            for r in range(band * plan.rows_per_band,
                           min(h_out, (band + 1) * plan.rows_per_band))]
    assert rows == list(range(h_out))
    # every output channel once: tiles of n_tile, the last ragged
    assert plan.n_tile in CONV_NTILES
    assert plan.co_tiles * plan.n_tile >= co > (plan.co_tiles - 1) * \
        plan.n_tile
    assert plan.grid == (plan.co_tiles, plan.bands, batch)
    # the layout the .cu recomputes, and the bytes the wrapper checks
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    assert (plan.taps, plan.kp, plan.ring_rows, plan.row_bytes,
            plan.smem_bytes) == conv_layout(c, w_out, k_h, k_w, s,
                                            plan.rows_per_band, plan.packed,
                                            plan.n_tile)
    # the instance the launcher takes: its tile (8 * WN * NF) is the plan's
    assert (plan.wn, plan.nf) == CONV_INSTANCES[plan.n_tile]
    assert 8 * plan.wn * plan.nf == plan.n_tile
    assert plan.kp % 32 == 0 and plan.kp >= (
        k_h * k_w * c if plan.packed else c)
    # every pixel of a band once, in chunks of CONV_MT; the ring holds the
    # rows of a chunk and of the next (in flight while it is computed),
    # and a slot is reused only for a row past both
    for chunks in _chunk_rows(plan, h_out, w_out, k_h, s):
        for q, (lo, hi) in enumerate(chunks):
            assert hi - lo <= plan.ring_rows
            if q + 1 < len(chunks):
                assert chunks[q + 1][1] - lo <= plan.ring_rows
                assert chunks[q + 1][0] >= lo


def _same(got, want):
    got = np.asarray(got)
    assert got.dtype == np.asarray(want).dtype and np.array_equal(
        got, np.asarray(want))


def _emulate(x, w, stride, plan):
    """What csrc/conv2d_int8.cu::conv_mma computes with ``plan``, in int64:
    the ring filled and read through its slots and stride phases exactly
    as the kernel does (the packed stem's raw rows and (k_h, k_w, C)
    patches included), garbage where the kernel writes nothing, and the
    weights as K-contiguous rows with zeros past the K rows."""
    rng = np.random.default_rng(0)
    B, H, W, C = x.shape
    k_h, k_w, _, co = w.shape
    h_out, pad_t = same_out_and_pad(H, k_h, stride)
    w_out, pad_l = same_out_and_pad(W, k_w, stride)
    packed, ring, rowb, kp = plan.packed, plan.ring_rows, plan.row_bytes, \
        plan.kp
    ceff = k_h * k_w * C if packed else C
    wpad = (w_out - 1) * stride + k_w
    q_slots = -(-wpad // stride)
    rs = min(stride, k_h)
    pix = kp + 16
    wt = np.zeros((plan.taps, co, kp), np.int64)     # [tap][C_out][K]
    wt[:, :, :ceff] = w.reshape(plan.taps, ceff, co).transpose(0, 2, 1)
    ktab = [(i, j * C + c) for i, j, c in stem_k_index(k_h, k_w, C)]
    out = np.zeros((B, h_out, w_out, co), np.int64)
    xpad = np.zeros((B, H + 2 * k_h + 2 * stride * CONV_MT,
                     W + 2 * k_w, C), np.int64)   # reads past any edge: 0
    off_h, off_w = k_h + stride * CONV_MT, k_w
    xpad[:, off_h:off_h + H, off_w:off_w + W] = x
    for b in range(B):
        for band in range(plan.bands):
            r0 = band * plan.rows_per_band
            p_band = (min(h_out, r0 + plan.rows_per_band) - r0) * w_out
            u0 = r0 * stride - pad_t
            smem = rng.integers(-128, 128, (ring, rowb)).astype(np.int64)
            n_chunks = -(-p_band // CONV_MT)

            def hi(q):
                return ((min(p_band, (q + 1) * CONV_MT) - 1) // w_out) \
                    * rs + k_h

            def fill(va, vb):
                for v in range(va, vb):
                    u = v // rs * stride + v % rs
                    row = xpad[b, off_h + u0 + u,
                               off_w - pad_l:off_w - pad_l + wpad]
                    slot = smem[v % ring]
                    if packed:
                        slot[:wpad * C] = row.reshape(-1)
                        continue
                    for p in range(wpad):
                        if p % stride < k_w:
                            at = (p % stride * q_slots + p // stride) * pix
                            slot[at:at + C] = row[p]

            if not packed:
                fill(0, hi(0))
                if n_chunks > 1:
                    fill(hi(0), hi(1))
            for q in range(n_chunks):
                pm = np.minimum(q * CONV_MT + np.arange(CONV_MT),
                                p_band - 1)
                rr, ow = pm // w_out, pm % w_out
                acc = np.zeros((CONV_MT, co), np.int64)
                if packed:
                    fill(hi(q - 1) if q else 0, hi(q))
                    tile = np.zeros((CONV_MT, kp), np.int64)
                    for k, (i, rem) in enumerate(ktab):
                        tile[:, k] = smem[(rr * rs + i) % ring,
                                          ow * stride * C + rem]
                    acc += tile @ wt[0].T
                else:
                    for i in range(k_h):
                        for j in range(k_w):
                            at = (j % stride * q_slots + ow + j // stride) \
                                * pix
                            a = np.stack([smem[(r * rs + i) % ring,
                                               s:s + kp]
                                          for r, s in zip(rr, at)])
                            acc += a @ wt[i * k_w + j].T
                valid = q * CONV_MT + np.arange(CONV_MT) < p_band
                out[b, r0 + rr[valid], ow[valid]] = acc[valid]
                if not packed and q + 2 < n_chunks:
                    fill(hi(q + 1), hi(q + 2))
    return out.astype(np.int32)


# (batch, h, w, C, C_out, k, stride, sm_count, the ring wraps): the stems
# (packed K), a 1x1 at stride 2 (odd rows and columns never read), C and
# C_out not multiples of 32, odd maps, and one SM so that a band holds
# many chunks and the ring wraps (at 132 SMs these small maps give short
# bands)
EMU_CASES = [
    (2, 9, 11, 3, 8, 7, 2, 132, False), (1, 160, 40, 3, 16, 7, 2, 1, True),
    (2, 9, 11, 3, 8, 3, 2, 132, False), (1, 13, 10, 8, 12, 3, 1, 1, False),
    (1, 120, 16, 32, 16, 3, 1, 1, True), (1, 200, 8, 48, 20, 3, 2, 1, True),
    (2, 9, 11, 16, 8, 1, 2, 132, False), (1, 120, 9, 16, 36, 1, 2, 1, True),
    (2, 9, 11, 64, 72, 1, 1, 1, False), (1, 7, 7, 96, 24, 3, 1, 132, False),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=[
    "b{}-{}x{}x{}-{}-k{}s{}-sm{}".format(*c[:8]) for c in EMU_CASES])
def test_emulated_kernel_matches_reference_and_pallas(case):
    batch, h, w, c, co, k, s, sms, wraps = case
    rng = np.random.default_rng(h * 100 + c)
    x = rng.integers(-127, 128, (batch, h, w, c)).astype(np.int8)
    wt = rng.integers(-127, 128, (k, k, c, co)).astype(np.int8)
    plan = conv_plan(batch, h, w, c, co, k, k, s, sms)
    assert (plan.ring_rows < (plan.rows_per_band - 1) * min(s, k) + k) \
        is wraps
    got = _emulate(x.astype(np.int64), wt.astype(np.int64), s, plan)
    want = conv2d_int8_ref(torch.from_numpy(x), torch.from_numpy(wt),
                           stride=s)
    _same(got, want.numpy())
    if h < 20:
        pallas = jax_conv(jnp.asarray(x), jnp.asarray(wt), stride=s,
                          interpret=True)
        _same(got, pallas)


def test_stem_k_index_is_the_hwio_order():
    w = np.arange(7 * 7 * 3 * 2).reshape(7, 7, 3, 2)
    flat = w.reshape(-1, 2)
    for k, (i, j, c) in enumerate(stem_k_index(7, 7, 3)):
        assert np.array_equal(flat[k], w[i, j, c])


@pytest.mark.parametrize("c,packed", [(3, True), (8, True), (12, True),
                                      (18, True), (16, False), (24, False),
                                      (144, False)])
def test_stem_packing_takes_small_or_unaligned_channels(c, packed):
    assert conv_packed(c) is packed


def test_conv_plan_rejects_c_out_not_multiple_of_4():
    with pytest.raises(ValueError, match="multiple of 4"):
        conv_plan(1, 14, 14, 32, 6, 3, 3, 1)
