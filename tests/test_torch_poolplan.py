"""The pool kernels' launch plans (``pool_int8/ops.py::pool_plan`` for
the maxpool, ``::gap_plan`` for the global average pool, mirrored by
``csrc/pool_int8.cu``) at every pool shape of the six CNN configs, at
batch 1 and 8, and at edge shapes: the CTAs cover every output pixel and
channel exactly once, the staged rows and columns hold every window's
taps that lie on the map, shared memory fits an H100 block.  Then what
each kernel computes with its plan, emulated in numpy as the ``.cu``
indexes it, against the plain versions and the JAX kernels in interpret
mode, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pool_int8.ops import (global_avgpool_int8 as jax_gap,
                                         maxpool_int8 as jax_maxpool)
from repro_torch.configs.cnn import CNN_CONFIGS
from repro_torch.kernels.conv2d_int8.ops import MAX_SMEM_BYTES
from repro_torch.kernels.conv2d_int8.ref import same_out_and_pad
from repro_torch.kernels.pool_int8.ops import (GAP_PIX, GAP_THREADS,
                                               POOL_INSTANCES,
                                               POOL_MIN_THREADS,
                                               POOL_SMEM_BUDGET,
                                               POOL_THREADS, POOL_WAVES,
                                               gap_plan, pool_layout,
                                               pool_plan)
from repro_torch.kernels.pool_int8.ref import (global_avgpool_int8_ref,
                                               maxpool_int8_ref)
from repro_torch.kernels.quant import reciprocal


def _pool_shapes():
    """(h, w, C, k, stride) of every maxpool and (h, w, C) of every global
    average pool of the six CNN configs."""
    mp, gap = set(), set()
    for cfg in CNN_CONFIGS.values():
        for ly in cfg.layers:
            if ly.kind == "maxpool":
                assert ly.k_h == ly.k_w
                mp.add((ly.in_h, ly.in_w, ly.c_in, ly.k_h, ly.stride))
            elif ly.kind == "gap":
                gap.add((ly.in_h, ly.in_w, ly.c_in))
    return sorted(mp), sorted(gap)


MAIN_MP, MAIN_GAP = _pool_shapes()
# odd H and W, k = 3 at stride 1 (SAME pads before the data), the generic
# instance (k = 5, k = 3 stride 3), C of 4 and 20 (4-byte copies), a map
# whose rows need column segments
EDGE_MP = [(13, 11, 64, 3, 2), (9, 7, 20, 3, 1), (7, 9, 4, 2, 2),
           (15, 17, 64, 3, 1), (10, 9, 20, 5, 2), (6, 5, 4, 3, 2),
           (11, 12, 32, 3, 3), (3, 1400, 64, 3, 2)]
MP_CASES = [(s, b) for s in MAIN_MP + EDGE_MP for b in (1, 8)]
EDGE_GAP = [(3, 5, 20), (4, 4, 6), (1, 1, 64), (56, 56, 48), (2, 3, 4)]
GAP_CASES = [(s, b) for s in MAIN_GAP + EDGE_GAP for b in (1, 2, 8)]


def test_every_pool_shape_is_listed():
    assert (112, 112, 64, 3, 2) in MAIN_MP               # the ResNet stems
    assert {(224, 224, 64, 2, 2), (14, 14, 512, 2, 2)} <= set(MAIN_MP)
    assert len(MAIN_MP) == 6
    assert {(7, 7, 512), (7, 7, 1280), (7, 7, 2048)} <= set(MAIN_GAP)


def _mp_id(case):
    (h, w, c, k, s), b = case
    return f"{h}x{w}x{c}-k{k}s{s}-b{b}"


def _walk(plan, batch, h, w, c, k, s):
    """Per CTA (band and segment, channel tile, image) as the kernel
    indexes it: the staged rows and columns (offsets from ih0, iw0) and
    the items (output row, output column, channel vector) its threads
    store."""
    h_out, pad_t = same_out_and_pad(h, k, s)
    w_out, pad_l = same_out_and_pad(w, k, s)
    cv = plan.cc // plan.vec
    for bx in range(plan.bands * plan.segs):
        band, sg = divmod(bx, plan.segs)
        oh0, ow0 = band * plan.rows, sg * plan.seg
        nr, nw = min(plan.rows, h_out - oh0), min(plan.seg, w_out - ow0)
        ih0, iw0 = oh0 * s - pad_t, ow0 * s - pad_l
        srows, scols = (nr - 1) * s + k, (nw - 1) * s + k
        chunks = -(-nw // plan.cols)
        for ct in range(plan.c_tiles):
            items = []
            for item in range(nr * chunks * cv):
                v, rest = item % cv, item // cv
                ch, r = rest % chunks, rest // chunks
                for j in range(plan.cols):
                    if ch * plan.cols + j < nw:
                        items.append((oh0 + r, ow0 + ch * plan.cols + j,
                                      ct * plan.cc + v * plan.vec, r,
                                      ch * plan.cols + j))
            yield ih0, iw0, srows, scols, items


@pytest.mark.parametrize("case", MP_CASES, ids=[_mp_id(c) for c in MP_CASES])
def test_pool_plan_covers_and_fits(case):
    (h, w, c, k, s), batch = case
    plan = pool_plan(batch, h, w, c, k, s)
    h_out, pad_t = same_out_and_pad(h, k, s)
    w_out, pad_l = same_out_and_pad(w, k, s)
    assert plan.vec == (16 if c % 16 == 0 else 4)
    assert plan.cc % plan.vec == 0 and c % plan.cc == 0
    assert plan.c_tiles == c // plan.cc
    assert plan.cols == POOL_INSTANCES.get((k, s), 1)
    assert plan.bands == -(-h_out // plan.rows)
    assert plan.segs == -(-w_out // plan.seg)
    assert plan.threads % 32 == 0
    assert POOL_MIN_THREADS <= plan.threads <= POOL_THREADS
    srows, scols, smem = pool_layout(plan.rows, plan.seg, plan.cc, k, s)
    assert plan.smem_bytes == smem <= MAX_SMEM_BYTES
    # within the stage budget, unless a segment cannot split further
    assert smem <= POOL_SMEM_BUDGET or plan.seg <= plan.cols
    seen = set()
    for ih0, iw0, sr, sc, items in _walk(plan, batch, h, w, c, k, s):
        assert sr <= srows and sc <= scols       # within the layout
        for oh, ow, ch, r, col in items:
            assert (oh, ow, ch) not in seen
            seen.add((oh, ow, ch))
            # every tap of the window on the map lies in the stage
            for i in range(k):
                ih = oh * s - pad_t + i
                if 0 <= ih < h:
                    assert 0 <= ih - ih0 < sr and ih - ih0 == r * s + i
                for j in range(k):
                    iw = ow * s - pad_l + j
                    if 0 <= iw < w:
                        assert 0 <= iw - iw0 < sc and \
                            iw - iw0 == col * s + j
    assert len(seen) == h_out * w_out * (c // plan.vec)
    # the main path's pools fill the card: POOL_WAVES waves, or the
    # narrowest channel chunk and segment
    if batch == 8 and (h, w, c, k, s) in MAIN_MP:
        ctas = plan.bands * plan.segs * plan.c_tiles * batch
        assert ctas >= POOL_WAVES * 132 or (plan.cc == 64 and plan.seg < 16)
        if k > s:                 # the rows two output rows share: once
            assert plan.rows >= 2


@pytest.mark.parametrize("c,what", [(6, "C % 4"), (64, "window")])
def test_pool_plan_refuses_what_the_kernel_does_not_take(c, what):
    with pytest.raises(ValueError, match=what):
        pool_plan(1, 8, 8, c, 3 if c == 6 else 0, 2)


def _emulate_maxpool(x, k, s, plan):
    """What maxpool_band computes with ``plan``: the stage holds only the
    taps on the map (the rest is never read), every item reduces the taps
    of its windows that lie on the map from -128."""
    batch, h, w, c = x.shape
    h_out, pad_t = same_out_and_pad(h, k, s)
    w_out, pad_l = same_out_and_pad(w, k, s)
    out = np.zeros((batch, h_out, w_out, c), np.int8)
    for b in range(batch):
        for ih0, iw0, sr, sc, items in _walk(plan, batch, h, w, c, k, s):
            stage = {}
            for r in range(sr):
                for cl in range(sc):
                    if 0 <= ih0 + r < h and 0 <= iw0 + cl < w:
                        stage[r, cl] = x[b, ih0 + r, iw0 + cl]
            for oh, ow, ch, r, col in items:
                acc = np.full(plan.vec, -128, np.int8)
                for i in range(k):
                    for j in range(k):
                        got = stage.get((r * s + i, col * s + j))
                        if got is not None:
                            acc = np.maximum(acc, got[ch:ch + plan.vec])
                out[b, oh, ow, ch:ch + plan.vec] = acc
    return out


@pytest.mark.parametrize("shape", EDGE_MP[:6], ids=[
    "{}x{}x{}-k{}s{}".format(*s) for s in EDGE_MP[:6]])
def test_emulated_maxpool_matches_reference_and_pallas(shape):
    h, w, c, k, s = shape
    rng = np.random.default_rng(h * w + c)
    x = rng.integers(-127, 128, size=(2, h, w, c), dtype=np.int8)
    got = _emulate_maxpool(x, k, s, pool_plan(2, h, w, c, k, s))
    want = maxpool_int8_ref(torch.from_numpy(x), k=k, stride=s).numpy()
    np.testing.assert_array_equal(got, want)
    pallas = jax_maxpool(jnp.asarray(x), k=k, stride=s, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def _gap_id(case):
    (h, w, c), b = case
    return f"{h}x{w}x{c}-b{b}"


@pytest.mark.parametrize("case", GAP_CASES,
                         ids=[_gap_id(c) for c in GAP_CASES])
def test_gap_plan_covers_and_fits(case):
    (h, w, c), batch = case
    plan = gap_plan(batch, h, w, c)
    assert plan.vec == (16 if c % 16 == 0 else 4 if c % 4 == 0 else 1)
    lanes = plan.cc // plan.vec
    assert plan.cc % plan.vec == 0 and 32 % lanes == 0
    assert plan.c_tiles == -(-c // plan.cc)
    # the warps' groups of lanes fill them; each thread at most GAP_PIX
    # pixels unless the CTA has its most warps
    assert plan.groups * lanes == plan.threads == 32 * plan.warps
    assert plan.threads <= GAP_THREADS
    assert plan.groups * GAP_PIX >= h * w or plan.threads == GAP_THREADS
    assert plan.warps == 1 or (plan.warps - 1) * plan.groups // plan.warps \
        * GAP_PIX < h * w
    assert plan.smem_bytes == (plan.warps * plan.cc * 4 if plan.warps > 1
                               else 0) <= MAX_SMEM_BYTES
    # every channel of every tile once; every pixel in one group
    chans = [ct * plan.cc + lane * plan.vec + e
             for ct in range(plan.c_tiles) for lane in range(lanes)
             for e in range(plan.vec) if ct * plan.cc + lane * plan.vec < c]
    assert sorted(chans) == list(range(c))
    pix = sorted(p for g in range(plan.groups)
                 for p in range(g, h * w, plan.groups))
    assert pix == list(range(h * w))
    if batch == 8 and (h, w, c) in MAIN_GAP:
        assert plan.c_tiles * batch >= 132 or plan.cc == plan.vec


def _emulate_gap(x, act_scale, plan):
    """What gap_chunk computes with ``plan``: per group of lanes the int32
    sums of its pixels, the groups' sums added, then the f32 epilogue."""
    batch, h, w, c = x.shape
    flat = x.reshape(batch, h * w, c).astype(np.int32)
    part = np.zeros((batch, plan.groups, c), np.int32)
    for g in range(plan.groups):
        part[:, g] = flat[:, g::plan.groups].sum(axis=1)
    s = part.sum(axis=1)
    m = s.astype(np.float32) * np.float32(reciprocal(h * w))
    r = np.rint(m * np.float32(reciprocal(act_scale)))
    return np.clip(r, -127, 127).astype(np.int8).reshape(batch, 1, 1, c)


@pytest.mark.parametrize("shape", [(7, 7, 512), (3, 5, 20), (4, 4, 6),
                                   (56, 56, 48)])
@pytest.mark.parametrize("act_scale", [0.05, 0.0123])
def test_emulated_gap_matches_reference_and_pallas(shape, act_scale):
    h, w, c = shape
    rng = np.random.default_rng(h * w * c)
    x = rng.integers(-127, 128, size=(2, h, w, c), dtype=np.int8)
    got = _emulate_gap(x, act_scale, gap_plan(2, h, w, c))
    want = global_avgpool_int8_ref(torch.from_numpy(x),
                                   act_scale=act_scale).numpy()
    np.testing.assert_array_equal(got, want)
    pallas = jax_gap(jnp.asarray(x), act_scale=act_scale, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
