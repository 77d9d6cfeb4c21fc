"""The depthwise kernel's launch plan (``conv2d_int8/ops.py::dw_plan``,
mirrored by ``csrc/dwconv_int8.cu``) at every dw layer of MobileNetV1,
V2 and V3, at batch 1 and 8, in both weight tiers: the CTAs cover every
output row and channel exactly once, one CTA's shared memory fits an
H100 block, the streamed tier's tap ring holds min(n_buffers, k*k) taps,
and the ring rows hold every column a thread's windows read, with the
column groups of a warp on distinct banks."""
import pytest

from repro_torch.configs.cnn import get_cnn
from repro_torch.kernels.conv2d_int8.ops import (DW_COLS, DW_MAX_THREADS,
                                                 DW_PREFETCH, MAX_SMEM_BYTES,
                                                 dw_bank_gap, dw_layout,
                                                 dw_plan)
from repro_torch.kernels.conv2d_int8.ref import same_out_and_pad


def _dw_shapes():
    shapes = set()
    for net in ("mobilenetv1", "mobilenetv2", "mobilenetv3"):
        for ly in get_cnn(net).layers:
            if ly.kind == "dwconv":
                shapes.add((ly.in_h, ly.in_w, ly.c_in, ly.k_h, ly.stride))
    return sorted(shapes)


DW_SHAPES = _dw_shapes()
CASES = [(shape, batch, stream, nb)
         for shape in DW_SHAPES for batch in (1, 8)
         for stream, nbs in ((False, (2,)), (True, (1, 2, shape[3] ** 2)))
         for nb in nbs]


def _id(case):
    (h, w, c, k, s), batch, stream, nb = case
    tier = f"stream{nb}" if stream else "pinned"
    return f"{h}x{w}x{c}-k{k}s{s}-b{batch}-{tier}"


def test_every_mobilenet_dw_shape_is_listed():
    assert len(DW_SHAPES) == 29
    assert {s[3] for s in DW_SHAPES} == {3, 5}
    assert {s[2] % 16 for s in DW_SHAPES} >= {0, 8}   # C = 72, 120, 184, 200


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_dw_plan_covers_and_fits(case):
    (h, w, c, k, s), batch, stream, nb = case
    plan = dw_plan(batch, h, w, c, k, s, stream, nb)
    h_out, _ = same_out_and_pad(h, k, s)
    w_out, _ = same_out_and_pad(w, k, s)
    # every output row once: bands are disjoint, non-empty and end at h_out
    rows = [r for band in range(plan.bands)
            for r in range(band * plan.rows_per_band,
                           min(h_out, (band + 1) * plan.rows_per_band))]
    assert rows == list(range(h_out))
    assert (plan.bands - 1) * plan.rows_per_band < h_out
    # every channel once: the tiles of 4 * quads channels, the last ragged;
    # a tile is a whole number of the row copies (16, 8 or 4 bytes)
    vec = 4 if c % 16 == 0 else 2 if c % 8 == 0 else 1
    assert plan.quads % vec == 0
    assert plan.c_tiles * 4 * plan.quads >= c
    assert (plan.c_tiles - 1) * 4 * plan.quads < c
    # every column once: the compute threads are quads x groups (thread
    # tid: quad tid % quads, group tid // quads), group g takes the chunks
    # g, g + groups, ... of plan.cols columns
    compute = plan.threads - (32 if stream else 0)
    assert compute % 32 == 0 and compute <= DW_MAX_THREADS
    assert plan.quads * plan.groups <= compute < plan.quads * plan.groups + 32
    nc = plan.cols
    assert nc in DW_COLS
    chunks = -(-w_out // nc)
    cols = sorted(ch * nc + n for g in range(plan.groups)
                  for ch in range(g, chunks, plan.groups)
                  for n in range(nc) if ch * nc + n < w_out)
    assert cols == list(range(w_out))
    assert plan.grid == (plan.c_tiles, plan.bands, batch)
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    assert plan.tap_slots == (min(nb, k * k) if stream else 0)
    assert plan.ring_rows == k + DW_PREFETCH * s
    assert (plan.ring_rows, plan.tap_slots, plan.row_words,
            plan.smem_bytes) == dw_layout(w_out, k, s, nc, plan.quads, stream,
                                          nb)


@pytest.mark.parametrize("shape", DW_SHAPES,
                         ids=["x".join(map(str, s)) for s in DW_SHAPES])
def test_dw_ring_rows_hold_windows_on_distinct_banks(shape):
    h, w, c, k, s = shape
    plan = dw_plan(8, h, w, c, k, s, False, 2)
    q, nc = plan.quads, plan.cols
    w_out, _ = same_out_and_pad(w, k, s)
    period = nc * s
    padw = dw_bank_gap(q, s, nc)

    def word(col):                      # csrc/dwconv_int8.cu::col_word
        return col * q + col // period * padw

    ndp = -(-k // 4)
    nt4 = -(-((nc - 1) * s + 4 * ndp) // 4)
    chunks = -(-w_out // nc)
    last_read = (chunks - 1) * period + 4 * nt4 - 1
    assert word(last_read) + q <= plan.row_words
    assert word((w_out - 1) * s + k - 1) + q <= plan.row_words
    # one load of every warp: its lanes tid (quad tid % q, group tid // q,
    # first chunk) read column j of their chunks
    for warp in range(plan.threads // 32):
        lanes = [t for t in range(32 * warp, 32 * warp + 32)
                 if t // q < plan.groups]
        for j in range(4 * nt4):
            banks = {(word(t // q * period + j) + t % q) % 32 for t in lanes}
            assert len(banks) == len(lanes)


@pytest.mark.parametrize("k,stride,c,nb,what", [
    (9, 1, 32, 2, "kernel size"), (3, 3, 32, 2, "stride"),
    (3, 1, 6, 2, "multiple of 4"), (3, 1, 32, 0, "n_buffers")])
def test_dw_plan_rejects_what_the_kernel_does_not_take(k, stride, c, nb,
                                                        what):
    with pytest.raises(ValueError, match=what):
        dw_plan(1, 14, 14, c, k, stride, True, nb)
