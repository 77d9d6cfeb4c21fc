"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device (the CPU test
run).  On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _i8(g, dev, *shape):
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8,
                         device=dev)


@pytest.mark.parametrize("k,stride,c_in,c_out,hw", [
    (1, 1, 16, 32, (9, 11)), (1, 2, 64, 36, (8, 8)), (3, 1, 8, 64, (9, 11)),
    (3, 2, 32, 40, (7, 9)), (7, 2, 3, 64, (20, 18)), (3, 1, 3, 4, (5, 5)),
])
def test_conv_kernel_matches_plain(dev, k, stride, c_in, c_out, hw):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.conv2d_int8.ops import (conv2d_int8,
                                                     conv2d_int8_requant)
    from repro_torch.kernels.conv2d_int8.ref import conv2d_int8_ref
    from repro_torch.kernels.quant import requant_epilogue
    g = torch.Generator(device=dev).manual_seed(k * 100 + c_in)
    x, w = _i8(g, dev, 3, *hw, c_in), _i8(g, dev, k, k, c_in, c_out)
    ws = torch.rand(c_out, generator=g, device=dev) * 0.1 + 0.01
    bias = torch.zeros(c_out, device=dev)
    want = conv2d_int8_ref(x, w, stride=stride)
    want_q, want_f = requant_epilogue(want, ws, bias, 0.05, True)
    reset_launches()
    assert torch.equal(conv2d_int8(x, w, stride=stride), want)
    for nb in sorted({1, 2, 3, k * k}):
        got = conv2d_int8(x, w, stride=stride, stream=True, n_buffers=nb)
        assert torch.equal(got, want), nb
    q, f = conv2d_int8_requant(x, w, ws, bias, 0.05, stride=stride,
                               want_float=True)
    assert torch.equal(q, want_q) and torch.equal(f, want_f)
    torch.cuda.synchronize()
    assert LAUNCHES["conv2d_int8_pinned"] == 2
    assert LAUNCHES["conv2d_int8_stream"] == len({1, 2, 3, k * k})


# The pinned tier's tensor-core kernel at the shapes its plan treats
# apart (batch, h, w, C, C_out, k, stride): the 7x7 stem (packed K), the
# 3x3 at 7x7x512 (a 32-channel tile: 147 KB of weights), a stride-2 3x3
# on an odd map, C not a multiple of 32 (16- and 8-byte row copies), C_out
# not a multiple of 32 (a ragged last tile), a 1x1 at stride 2, the 3x3
# stem, and a 1x1, a 3x3 and a stride-2 3x3 whose ring wraps within a band
WRAPS = {(8, 112, 112, 16, 96, 1, 1), (8, 56, 56, 64, 512, 3, 1),
         (8, 56, 56, 128, 256, 3, 2)}


@pytest.mark.parametrize("shape", [
    (8, 224, 224, 3, 64, 7, 2), (8, 7, 7, 512, 512, 3, 1),
    (2, 29, 31, 64, 128, 3, 2), (2, 14, 14, 48, 64, 3, 1),
    (2, 14, 14, 24, 40, 1, 1), (2, 28, 28, 144, 36, 1, 2),
    (8, 56, 56, 256, 512, 1, 2), (2, 224, 224, 3, 32, 3, 2),
    *sorted(WRAPS)])
def test_conv_mma_matches_plain(dev, shape):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.conv2d_int8.ops import (_sm_count, conv2d_int8,
                                                     conv2d_int8_requant,
                                                     conv_plan)
    from repro_torch.kernels.conv2d_int8.ref import conv2d_int8_ref
    from repro_torch.kernels.quant import requant_epilogue
    batch, h, w, c, co, k, stride = shape
    plan = conv_plan(batch, h, w, c, co, k, k, stride,
                     _sm_count(dev.index or 0))
    if (c, k) == (512, 3):
        assert plan.n_tile == 32
    assert (plan.ring_rows < (plan.rows_per_band - 1) * min(stride, k)
            + k) is (shape in WRAPS)
    g = torch.Generator(device=dev).manual_seed(h * 1000 + c)
    x, wt = _i8(g, dev, batch, h, w, c), _i8(g, dev, k, k, c, co)
    ws = torch.rand(co, generator=g, device=dev) * 0.1 + 0.01
    bias = torch.randn(co, generator=g, device=dev)
    want = conv2d_int8_ref(x, wt, stride=stride)
    reset_launches()
    assert torch.equal(conv2d_int8(x, wt, stride=stride), want)
    for relu in (True, False):
        want_q, want_f = requant_epilogue(want, ws, bias, 0.05, relu)
        q, f = conv2d_int8_requant(x, wt, ws, bias, 0.05, stride=stride,
                                   relu=relu, want_float=True)
        assert torch.equal(q, want_q) and torch.equal(f, want_f)
        q, f = conv2d_int8_requant(x, wt, ws, bias, 0.05, stride=stride,
                                   relu=relu)
        assert f is None and torch.equal(q, want_q)
    torch.cuda.synchronize()
    assert LAUNCHES == {"conv2d_int8_pinned": 5}


# The streamed tier's tensor-core kernel at the shapes its plan treats
# apart (batch, h, w, C, C_out, k, stride): a 7x7 map at batch 8 (the
# batch rides M: 56 pixels), the stride-2 3x3 at 14x14, a 1x1 at C = 2048
# (three K blocks), VGG-16's fc0 (7x7 stride 7 on a 7x7 map: M = 8), the
# 7x7 stem (C = 3: byte copies, two column segments), a ragged C_out
# (4-byte weight loads), a 28x28 map (two images a CTA, four-row bands)
# and a batch the image groups do not divide
@pytest.mark.parametrize("shape", [
    (8, 7, 7, 512, 512, 3, 1), (8, 14, 14, 512, 512, 3, 2),
    (8, 7, 7, 2048, 512, 1, 1), (8, 7, 7, 512, 4096, 7, 7),
    (2, 224, 224, 3, 64, 7, 2), (3, 14, 14, 48, 36, 3, 1),
    (8, 28, 28, 256, 128, 3, 1), (5, 14, 14, 64, 64, 1, 2)])
def test_conv_stream_matches_plain(dev, shape):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.conv2d_int8.ops import (_sm_count, conv2d_int8,
                                                     conv2d_int8_requant,
                                                     stream_plan)
    from repro_torch.kernels.conv2d_int8.ref import conv2d_int8_ref
    from repro_torch.kernels.quant import requant_epilogue
    batch, h, w, c, co, k, stride = shape
    g = torch.Generator(device=dev).manual_seed(h * 1000 + c + co)
    x, wt = _i8(g, dev, batch, h, w, c), _i8(g, dev, k, k, c, co)
    ws = torch.rand(co, generator=g, device=dev) * 0.1 + 0.01
    bias = torch.randn(co, generator=g, device=dev)
    want = conv2d_int8_ref(x, wt, stride=stride)
    reset_launches()
    nbs = sorted({1, 2, 3, k * k})
    for nb in nbs:
        stream_plan(batch, h, w, c, co, k, k, stride, nb,
                    _sm_count(dev.index or 0))
        assert torch.equal(conv2d_int8(x, wt, stride=stride, stream=True,
                                       n_buffers=nb), want), nb
    for relu in (True, False):
        want_q, want_f = requant_epilogue(want, ws, bias, 0.05, relu)
        q, f = conv2d_int8_requant(x, wt, ws, bias, 0.05, stride=stride,
                                   relu=relu, stream=True, want_float=True)
        assert torch.equal(q, want_q) and torch.equal(f, want_f)
    torch.cuda.synchronize()
    assert LAUNCHES == {"conv2d_int8_stream": len(nbs) + 2}


@pytest.mark.parametrize("k,stride,hw", [(3, 2, (112, 112)), (3, 2, (9, 8)),
                                         (2, 2, (7, 7))])
def test_maxpool_kernel_matches_plain(dev, k, stride, hw):
    from repro_torch.kernels.pool_int8.ops import maxpool_int8
    from repro_torch.kernels.pool_int8.ref import maxpool_int8_ref
    g = torch.Generator(device=dev).manual_seed(hw[0])
    x = _i8(g, dev, 2, *hw, 64)
    assert torch.equal(maxpool_int8(x, k=k, stride=stride),
                       maxpool_int8_ref(x, k=k, stride=stride))


@pytest.mark.parametrize("shape", [(8, 7, 7, 2048), (2, 3, 5, 20)])
def test_gap_kernel_matches_plain(dev, shape):
    from repro_torch.kernels.pool_int8.ops import global_avgpool_int8
    from repro_torch.kernels.pool_int8.ref import global_avgpool_int8_ref
    g = torch.Generator(device=dev).manual_seed(shape[-1])
    x = _i8(g, dev, *shape)
    for act in (0.05, 0.1):
        assert torch.equal(global_avgpool_int8(x, act_scale=act),
                           global_avgpool_int8_ref(x, act_scale=act))


# K5 at the main path's shapes at batch 8 (ResNet's 3x3/2 stem pool: two
# rows a band; VGG-16's five 2x2/2 pools: channel chunks) and at
# edge shapes: odd H and W, k = 3 with s = 1 (SAME pads before the data),
# the generic instance (k = 5), C in {4, 20, 64} (4-byte copies below 16)
@pytest.mark.parametrize("shape,k,stride", [
    ((8, 112, 112, 64), 3, 2), ((8, 224, 224, 64), 2, 2),
    ((8, 112, 112, 128), 2, 2), ((8, 56, 56, 256), 2, 2),
    ((8, 28, 28, 512), 2, 2), ((8, 14, 14, 512), 2, 2),
    ((2, 13, 11, 64), 3, 2), ((2, 9, 7, 20), 3, 1), ((3, 7, 9, 4), 2, 2),
    ((2, 15, 17, 64), 3, 1), ((2, 10, 9, 20), 5, 2), ((1, 6, 5, 4), 3, 2)])
def test_maxpool_band_matches_plain(dev, shape, k, stride):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.pool_int8.ops import maxpool_int8
    from repro_torch.kernels.pool_int8.ref import maxpool_int8_ref
    g = torch.Generator(device=dev).manual_seed(sum(shape) + k)
    x = _i8(g, dev, *shape)
    reset_launches()
    assert torch.equal(maxpool_int8(x, k=k, stride=stride),
                       maxpool_int8_ref(x, k=k, stride=stride))
    # the all -128 map: padding and data alike give -128
    neg = torch.full_like(x, -128)
    assert torch.equal(maxpool_int8(neg, k=k, stride=stride),
                       maxpool_int8_ref(neg, k=k, stride=stride))
    torch.cuda.synchronize()
    assert LAUNCHES == {"maxpool_int8": 2}


# K6 at the main path's shapes at batch 8 (ResNet-18, MobileNetV2,
# ResNet-50) and at edge shapes: 4-byte and byte loads (C = 20, 6), one
# pixel, many pixels a group
@pytest.mark.parametrize("shape", [(8, 7, 7, 512), (8, 7, 7, 1280),
                                   (8, 7, 7, 2048), (2, 3, 5, 20),
                                   (3, 4, 4, 6), (2, 1, 1, 64),
                                   (1, 56, 56, 48)])
def test_gap_chunk_matches_plain(dev, shape):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.pool_int8.ops import global_avgpool_int8
    from repro_torch.kernels.pool_int8.ref import global_avgpool_int8_ref
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x = _i8(g, dev, *shape)
    reset_launches()
    for act in (0.05, 0.1, 0.0123):
        assert torch.equal(global_avgpool_int8(x, act_scale=act),
                           global_avgpool_int8_ref(x, act_scale=act))
    for v in (127, -127):        # the largest sums, and the clip
        full = torch.full_like(x, v)
        assert torch.equal(global_avgpool_int8(full, act_scale=0.05),
                           global_avgpool_int8_ref(full, act_scale=0.05))
    torch.cuda.synchronize()
    assert LAUNCHES == {"global_avgpool_int8": 5}


# the float modes of K7/K8 (mm_float), limits of tests/test_kernels.py
def _float_tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def _check_float(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = _float_tol(want.dtype)
    w = want.double()
    bound = tol * w.abs() + tol * float(w.abs().max())
    assert bool(((got.double() - w).abs() <= bound).all()), \
        float((got.double() - w).abs().max())


def _float_operands(g, dev, m, k, n, xd, wd):
    return (torch.randn(m, k, generator=g, device=dev).to(xd),
            torch.randn(k, n, generator=g, device=dev).to(wd))


# tests/test_kernels.py's MM_SHAPES in both types and all three modes, the
# fifo ring 1 to 4 deep, with K blocks of 128 (the JAX test's) and of 16
# (rings of many blocks)
@pytest.mark.parametrize("shape", [(128, 256, 128), (256, 1024, 384),
                                   (128, 512, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_float_kernel_matches_plain(dev, shape, dtype):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.stream_matmul.ops import stream_matmul
    from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x, w = _float_operands(g, dev, *shape, dtype, dtype)
    want = stream_matmul_ref(x, w)
    reset_launches()
    runs = [("pinned", 2, 128), ("stream", 2, 128), ("stream", 2, 16)] + [
        ("fifo", nb, bk) for nb in (1, 2, 3, 4) for bk in (128, 16)]
    for mode, nb, bk in runs:
        _check_float(stream_matmul(x, w, mode=mode, bk=bk, n_buffers=nb),
                     want)
    torch.cuda.synchronize()
    assert LAUNCHES == {"stream_matmul_float_pinned": 3,
                        "stream_matmul_float_fifo": 8}


# mixed operands, and a ragged shape (M = 17, K = 100, N = 36: three row
# tiles, a ragged K split, 8-byte bf16 row copies)
@pytest.mark.parametrize("xd,wd", [(torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.float32),
                                   (torch.bfloat16, torch.bfloat16),
                                   (torch.float32, torch.float32)])
@pytest.mark.parametrize("shape", [(17, 100, 36), (128, 256, 128),
                                   (5, 33, 7)])
def test_matmul_float_mixed_and_ragged(dev, xd, wd, shape):
    from repro_torch.kernels.stream_matmul.ops import stream_matmul
    from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x, w = _float_operands(g, dev, *shape, xd, wd)
    want = stream_matmul_ref(x, w)
    for mode, nb in (("pinned", 2), ("stream", 2), ("fifo", 1), ("fifo", 3)):
        _check_float(stream_matmul(x, w, mode=mode, bk=16, n_buffers=nb),
                     want)


# every fc head of the six CNN configs at M = 8, as the engines stream
# them (K blocks of at most 512), in both types and the three modes
@pytest.mark.parametrize("k,n", [(512, 1000), (1024, 1000), (1280, 1000),
                                 (2048, 1000), (4096, 4096), (4096, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_float_fc_heads_match_plain(dev, k, n, dtype):
    from repro_torch.compiler.engines import _block
    from repro_torch.kernels.stream_matmul.ops import stream_matmul
    from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref
    g = torch.Generator(device=dev).manual_seed(k + n)
    x, w = _float_operands(g, dev, 8, k, n, dtype, dtype)
    want = stream_matmul_ref(x, w)
    for mode in ("pinned", "stream", "fifo"):
        _check_float(stream_matmul(x, w, mode=mode, bk=_block(k, 512)), want)


def test_matmul_float_refuses_other_types(dev):
    """Types outside f32, bf16, f16 and int8 (which take every pair) are
    refused, never sent to another kernel."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.stream_matmul.ops import stream_matmul
    reset_launches()
    x = torch.ones(8, 64, device=dev)
    w = torch.ones(64, 32, device=dev)
    for a, b in ((x.double(), w), (x, w.double()), (x.to(torch.int32), w),
                 (x.half(), w.to(torch.int16)),
                 (x.to(torch.int8), w.to(torch.int32))):
        with pytest.raises(NotImplementedError, match="not torch"):
            stream_matmul(a, b)
    assert LAUNCHES == {}


# the pairs with an f16 or int8 operand: every pair over f32, bf16, f16
# and int8 but int8 x int8 and those of f32 and bf16 alone, the result of
# the promoted type (f16 within the bf16 limit)
NEW_FLOAT_PAIRS = [(a, b) for a in (torch.float32, torch.bfloat16,
                                    torch.float16, torch.int8)
                   for b in (torch.float32, torch.bfloat16, torch.float16,
                             torch.int8)
                   if torch.float16 in (a, b) or
                   (torch.int8 in (a, b) and a != b)]


def _typed_operands(g, dev, m, k, n, xd, wd):
    """x, w normal from ``g`` (int8: integers in [-127, 127])."""
    def draw(shape, dt):
        if dt == torch.int8:
            return torch.randint(-127, 128, shape, generator=g, device=dev,
                                 dtype=torch.int8)
        return torch.randn(*shape, generator=g, device=dev).to(dt)
    return draw((m, k), xd), draw((k, n), wd)


@pytest.mark.parametrize("xd,wd", NEW_FLOAT_PAIRS)
@pytest.mark.parametrize("shape", [(17, 100, 36), (128, 256, 128),
                                   (5, 33, 7), (8, 2048, 1000)])
def test_matmul_float_new_pairs_match_plain(dev, xd, wd, shape):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.stream_matmul.ops import stream_matmul
    from repro_torch.kernels.stream_matmul.ref import (result_dtype,
                                                       stream_matmul_ref)
    assert len(NEW_FLOAT_PAIRS) == 11
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    x, w = _typed_operands(g, dev, *shape, xd, wd)
    want = stream_matmul_ref(x, w)
    assert want.dtype == result_dtype(xd, wd)
    reset_launches()
    for mode, nb, bk in (("pinned", 2, 128), ("stream", 2, 16),
                         ("fifo", 1, 16), ("fifo", 3, 128)):
        got = stream_matmul(x, w, mode=mode, bk=bk, n_buffers=nb)
        tol = 2e-5 if want.dtype == torch.float32 else 2e-2
        wd_ = want.double()
        bound = tol * wd_.abs() + tol * float(wd_.abs().max())
        assert got.dtype == want.dtype and got.shape == want.shape
        assert bool(((got.double() - wd_).abs() <= bound).all()), \
            (mode, float((got.double() - wd_).abs().max()))
    torch.cuda.synchronize()
    assert LAUNCHES == {"stream_matmul_float_pinned": 2,
                        "stream_matmul_float_fifo": 2}


# every pair over f32, bf16, f16 and int8 but int8 x int8 (the eleven
# with bf16, f16 or int8 weights on the tensor cores, mm_float_tc; the four
# with f32 weights on FFMA, mm_float) at ragged shapes: M of 1, 8, 9 and
# 17 rows, N of 10, 36 and 1000 columns (and 4096, where the tensor cores
# take 128-column tiles),
# K = 100 over a K split of more than one rank, in the three modes,
# within the output type's limit (f16 within bf16's)
FLOAT_NAMES = ("float32", "bfloat16", "float16", "int8")
ALL_FLOAT_PAIRS = [(a, b) for a in FLOAT_NAMES for b in FLOAT_NAMES
                   if (a, b) != ("int8", "int8")]


@pytest.mark.parametrize("n", [10, 36, 1000, 4096])
@pytest.mark.parametrize("m", [1, 8, 9, 17])
@pytest.mark.parametrize("xd,wd", ALL_FLOAT_PAIRS)
def test_matmul_float_every_pair_at_ragged_shapes(dev, xd, wd, m, n):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels._build import SHAPE_LAUNCHES
    from repro_torch.kernels.conv2d_int8.ops import _device_sms
    from repro_torch.kernels.stream_matmul.ops import (FLOAT_KERNELS,
                                                       float_instance,
                                                       mm_float_plan,
                                                       stream_matmul)
    from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref
    xt, wt = getattr(torch, xd), getattr(torch, wd)
    g = torch.Generator(device=dev).manual_seed(m * 1000 + n)
    x, w = _typed_operands(g, dev, m, 100, n, xt, wt)
    want = stream_matmul_ref(x, w)
    runs = (("pinned", 2, 128), ("stream", 2, 32), ("fifo", 1, 32),
            ("fifo", 3, 64))
    instances = {}
    for mode, nb, bk in runs:
        plan = mm_float_plan(m, 100, n, mode, bk, nb, x.element_size(),
                             w.element_size(), _device_sms(dev))
        key = (FLOAT_KERNELS[mode], float_instance(xt, wt, plan.tn))
        instances[key] = instances.get(key, 0) + 1
        assert plan.tensor_cores == (wt != torch.float32)
        if n < 4096:
            assert plan.split > 1
        elif plan.tensor_cores:
            assert plan.tn == 128
    reset_launches()
    for mode, nb, bk in runs:
        got = stream_matmul(x, w, mode=mode, bk=bk, n_buffers=nb)
        tol = 2e-5 if want.dtype == torch.float32 else 2e-2
        wd_ = want.double()
        bound = tol * wd_.abs() + tol * float(wd_.abs().max())
        assert got.dtype == want.dtype and got.shape == want.shape
        assert bool(((got.double() - wd_).abs() <= bound).all()), \
            (mode, float((got.double() - wd_).abs().max()))
    torch.cuda.synchronize()
    assert LAUNCHES == {"stream_matmul_float_pinned": 2,
                        "stream_matmul_float_fifo": 2}
    assert {k: v for k, v in SHAPE_LAUNCHES.items()
            if k[0] in LAUNCHES} == instances


# the tensor-core pairs on the TMA route (rows of 16-byte multiples; one or
# two 128-byte boxes of a column tile): ragged M (1, 9, 17 rows), N past
# the last 128-column tile (4160), K past the last 32-row unit of a range
# (1040, 2080), in the stream and fifo modes (the route) and pinned
TMA_SHAPES = [(1, 1040, 4096), (9, 1040, 4160), (17, 2080, 4160)]


@pytest.mark.parametrize("shape", TMA_SHAPES, ids=[
    "m{}-k{}-n{}".format(*s) for s in TMA_SHAPES])
@pytest.mark.parametrize("xd,wd", [p for p in ALL_FLOAT_PAIRS
                                   if p[1] != "float32"])
def test_matmul_float_tma_route_matches_plain(dev, xd, wd, shape):
    from repro_torch.kernels.conv2d_int8.ops import _device_sms
    from repro_torch.kernels.stream_matmul.ops import (mm_float_plan,
                                                       stream_matmul)
    from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref
    m, k, n = shape
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x, w = _typed_operands(g, dev, m, k, n, getattr(torch, xd),
                           getattr(torch, wd))
    want = stream_matmul_ref(x, w)
    for mode, nb, bk in (("stream", 2, 512), ("fifo", 1, 256),
                         ("fifo", 3, 512), ("pinned", 2, 512)):
        plan = mm_float_plan(m, k, n, mode, bk, nb, x.element_size(),
                             w.element_size(), _device_sms(dev))
        assert plan.tma or mode == "pinned"
        got = stream_matmul(x, w, mode=mode, bk=bk, n_buffers=nb)
        tol = 2e-5 if want.dtype == torch.float32 else 2e-2
        wd_ = want.double()
        bound = tol * wd_.abs() + tol * float(wd_.abs().max())
        assert got.dtype == want.dtype and got.shape == want.shape
        assert bool(((got.double() - wd_).abs() <= bound).all()), \
            (mode, float((got.double() - wd_).abs().max()))


# The f32-x pairs on the tensor cores (x split exactly into three bf16
# parts) on edge values, at a ragged shape (the cp.async route) and a TMA
# one: a row of x holds normal values but, by its index mod 8, one column
# of EDGE_BITS (+inf, -inf, a NaN whose payload has only low bits, the
# largest finite f32, a value above bf16's largest that round to nearest
# makes -inf), zeros and -0 (5), values near 2^-105, inside the split's
# exact range from 2^-110 (6), or values near 2^-128 below it with the
# smallest normal and subnormal (7); w normal x 0.25 (int8: [-127, 127]).
# inf and NaN where the plain version has them, finite outputs within the
# f32 limit of their row plus the split's bound (2^-133 |w|) for x's
# values below 2^-110 (chip_smoke.py's edge_err)
EDGE_BITS = (0x7f800000, 0xff800000, 0x7f800001, 0x7f7fffff, 0xff7f8001)


def _edge_operands(g, dev, m, k, n, wd):
    x = torch.randn(m, k, generator=g, device=dev)
    bits = x.view(torch.int32)
    cols = torch.randint(0, k, (m,), generator=g, device=dev).tolist()
    for r in range(m):
        kind = r % 8
        if kind < 5:
            bits[r, cols[r]] = EDGE_BITS[kind] - (
                1 << 32 if EDGE_BITS[kind] >> 31 else 0)
        elif kind == 5:
            x[r, ::2] = 0.0
            x[r, 1::4] = -0.0
        elif kind == 6:
            x[r] *= 2.0 ** -105
        else:
            x[r] *= 2.0 ** -128
            bits[r, :2] = torch.tensor([0x00800000, 1], dtype=torch.int32)
    if wd == torch.int8:
        return x, _i8(g, dev, k, n)
    return x, (torch.randn(k, n, generator=g, device=dev) * 0.25).to(wd)


@pytest.mark.parametrize("shape", [(17, 100, 36), (17, 2080, 4160)])
@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float16, torch.int8])
def test_matmul_float_f32_x_edge_values(dev, wd, shape):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels._build import SHAPE_LAUNCHES
    from repro_torch.kernels.conv2d_int8.ops import _device_sms
    from repro_torch.kernels.stream_matmul.ops import (mm_float_plan,
                                                       stream_matmul)
    from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref
    m, k, n = shape
    g = torch.Generator(device=dev).manual_seed(k + n)
    x, w = _edge_operands(g, dev, m, k, n, wd)
    want = stream_matmul_ref(x, w).double()
    nan, inf, fin = want.isnan(), want.isinf(), want.isfinite()
    assert nan.any() and inf.any() and fin.any()
    row = torch.where(fin, want.abs(), torch.zeros_like(want)).amax(
        1, keepdim=True)
    below = ((x.abs() < 2.0 ** -110) & (x != 0)).double()
    limit = 2e-5 * want.abs() + 2e-5 * row \
        + 2.0 ** -133 * (below @ w.double().abs())
    reset_launches()
    for mode, nb, bk in (("fifo", 2, 512), ("stream", 2, 32),
                         ("pinned", 2, 512)):
        plan = mm_float_plan(m, k, n, mode, bk, nb, 4, w.element_size(),
                             _device_sms(dev))
        assert plan.tensor_cores and plan.tma == (n == 4160 and
                                                  mode != "pinned")
        got = stream_matmul(x, w, mode=mode, bk=bk, n_buffers=nb).double()
        assert torch.equal(got.isnan(), nan) and torch.equal(got.isinf(), inf)
        assert torch.equal(got[inf], want[inf])
        assert bool(((got - want).abs()[fin] <= limit[fin]).all()), \
            (mode, float(((got - want).abs() / limit)[fin].max()))
    torch.cuda.synchronize()
    assert sum(LAUNCHES.values()) == 3
    assert all(i.startswith("mm_float_tc<f32,") for _, i in SHAPE_LAUNCHES)


@pytest.mark.parametrize("m,k,n", [(8, 2048, 1000), (3, 100, 10),
                                   (17, 512, 36)])
@pytest.mark.parametrize("mode,nb", [("pinned", 2), ("stream", 2),
                                     ("fifo", 1), ("fifo", 3)])
def test_matmul_kernel_matches_plain(dev, m, k, n, mode, nb):
    from repro_torch.kernels.quant import requant_epilogue
    from repro_torch.kernels.stream_matmul.ops import (stream_matmul,
                                                       stream_matmul_requant)
    from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref
    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x, w = _i8(g, dev, m, k), _i8(g, dev, k, n)
    ws = torch.full((n,), 0.05, device=dev)
    bias = torch.zeros(n, device=dev)
    want = stream_matmul_ref(x, w)
    assert torch.equal(stream_matmul(x, w, mode=mode, bk=64, n_buffers=nb),
                       want)
    q, f = stream_matmul_requant(x, w, ws, bias, 0.05, relu=False, mode=mode,
                                 bk=64, n_buffers=nb)
    want_q, want_f = requant_epilogue(want, ws, bias, 0.05, False)
    assert torch.equal(q, want_q) and torch.equal(f, want_f)


# VGG-16's streamed heads as the engine launches them (fifo, K blocks of
# 512 at most, n_buffers 2): fc1 (a K split of 4 over a cluster) and fc2
# (N = 1000: 8-byte copies, a split of 8); and fc1 pinned
@pytest.mark.parametrize("k,n,mode", [(4096, 4096, "fifo"),
                                      (4096, 1000, "fifo"),
                                      (4096, 4096, "pinned")])
def test_matmul_vgg_heads_match_plain(dev, k, n, mode):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.conv2d_int8.ops import _sm_count
    from repro_torch.kernels.quant import requant_epilogue
    from repro_torch.kernels.stream_matmul.ops import (mm_plan,
                                                       stream_matmul,
                                                       stream_matmul_requant)
    from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref
    g = torch.Generator(device=dev).manual_seed(k + n)
    x, w = _i8(g, dev, 8, k), _i8(g, dev, k, n)
    ws = torch.rand(n, generator=g, device=dev) * 0.1 + 0.01
    bias = torch.randn(n, generator=g, device=dev)
    plan = mm_plan(8, k, n, mode, 512, 2, _sm_count(dev.index or 0))
    assert plan.n_tiles * plan.split >= 128
    want = stream_matmul_ref(x, w)
    reset_launches()
    assert torch.equal(stream_matmul(x, w, mode=mode, bk=512), want)
    for relu in (True, False):
        q, f = stream_matmul_requant(x, w, ws, bias, 0.05, relu=relu,
                                     mode=mode, bk=512)
        want_q, want_f = requant_epilogue(want, ws, bias, 0.05, relu)
        assert torch.equal(q, want_q) and torch.equal(f, want_f)
    torch.cuda.synchronize()
    assert LAUNCHES == {f"stream_matmul_{mode}": 3}


@pytest.mark.parametrize("name", ["mini_resnet18", "mini_resnet50",
                                  "mini_mobilenet"])
def test_mini_net_on_card_matches_cpu(dev, name):
    from repro_torch.compiler import MINI, compile
    from repro_torch.configs import cnn
    from repro_torch.models.cnn import cnn_input_shape, init_cnn_params
    cfg = getattr(cnn, name)()
    gen = torch.Generator().manual_seed(0)
    params = init_cnn_params(cfg, gen, "cpu")
    x = torch.randint(-127, 128, cnn_input_shape(cfg, 2), generator=gen,
                      dtype=torch.int8)
    comp = compile(cfg, MINI)
    want, _ = comp.run(params, x, device="cpu")
    on_card = {n: {k: v.to(dev) for k, v in p.items()}
               for n, p in params.items()}
    got, rep = comp.run(on_card, x.to(dev))
    assert torch.equal(got.cpu(), want)
    rep.verify()
    if name == "mini_mobilenet":          # every dw layer on the HBM tier
        dw = {s.spec.name for s in comp.schedules if s.spec.kind == "dwconv"}
        forced = comp.with_offload(set(comp.streamed_names) | dw)
        got, rep = forced.run(on_card, x.to(dev))
        assert torch.equal(got.cpu(), want)
        assert set(rep.hbm_weight_words) >= dw
        rep.verify()


# (C, (H, W)): the original cases; C = 72 and 200 (C % 16 = 8), 12
# (C % 8 = 4) and 184; odd maps, where 5x5 at stride 2 pads only one side
# of each pair
@pytest.mark.parametrize("c,hw", [(32, (9, 11)), (960, (7, 7)),
                                  (144, (56, 56)), (8, (8, 6)),
                                  (72, (29, 31)), (200, (14, 14)),
                                  (12, (13, 10)), (184, (15, 13))])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_dwconv_kernel_matches_plain(dev, k, stride, c, hw):
    _check_dwconv(dev, 3, k, stride, c, hw)


# MobileNetV2's first dw layer at batch 8, and a map whose output height
# is not a multiple of the pinned tier's band
@pytest.mark.parametrize("hw", [(112, 112), (113, 112)])
def test_dwconv_kernel_full_width_batch8(dev, hw):
    from repro_torch.kernels.conv2d_int8.ops import _sm_count, dw_plan
    from repro_torch.kernels.conv2d_int8.ref import same_out_and_pad
    if hw[0] == 113:
        h_out, _ = same_out_and_pad(hw[0], 3, 1)
        plan = dw_plan(8, *hw, 32, 3, 1, False, 2, _sm_count(dev.index or 0))
        assert h_out % plan.rows_per_band, plan
    _check_dwconv(dev, 8, 3, 1, 32, hw)


def _check_dwconv(dev, batch, k, stride, c, hw):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.conv2d_int8.ops import (conv2d_int8,
                                                     conv2d_int8_requant)
    from repro_torch.kernels.conv2d_int8.ref import conv2d_int8_ref
    from repro_torch.kernels.quant import requant_epilogue
    g = torch.Generator(device=dev).manual_seed(k * 1000 + c + stride)
    x, w = _i8(g, dev, batch, *hw, c), _i8(g, dev, k, k, 1, c)
    ws = torch.rand(c, generator=g, device=dev) * 0.1 + 0.01
    bias = torch.randn(c, generator=g, device=dev)
    want = conv2d_int8_ref(x, w, stride=stride, depthwise=True)
    reset_launches()
    for relu in (True, False):
        want_q, want_f = requant_epilogue(want, ws, bias, 0.05, relu)
        for stream, nbs in ((False, (2,)), (True, sorted({1, 2, k * k}))):
            for nb in nbs:
                got = conv2d_int8(x, w, stride=stride, stream=stream,
                                  n_buffers=nb, depthwise=True)
                assert torch.equal(got, want), (stream, nb)
                q, f = conv2d_int8_requant(
                    x, w, ws, bias, 0.05, stride=stride, relu=relu,
                    stream=stream, n_buffers=nb, depthwise=True,
                    want_float=True)
                assert torch.equal(q, want_q) and torch.equal(f, want_f)
                q, f = conv2d_int8_requant(
                    x, w, ws, bias, 0.05, stride=stride, relu=relu,
                    stream=stream, n_buffers=nb, depthwise=True)
                assert f is None and torch.equal(q, want_q)
    torch.cuda.synchronize()
    assert LAUNCHES["dwconv_int8_pinned"] == 6
    assert LAUNCHES["dwconv_int8_stream"] == 6 * len({1, 2, k * k})


def test_dwconv_rejects_channels_not_multiple_of_4(dev):
    from repro_torch.kernels.conv2d_int8.ops import (conv2d_int8,
                                                     conv2d_int8_requant)
    x = torch.zeros((1, 4, 4, 6), dtype=torch.int8, device=dev)
    w = torch.zeros((3, 3, 1, 6), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        conv2d_int8(x, w, depthwise=True)
    ones = torch.ones(6, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        conv2d_int8_requant(x, w, ones, ones, depthwise=True, stream=True)


# the five ATTN_CASES of tests/test_kernels.py, one hd != hd_v case, a
# ragged length, the Phi-4-mini prefill shape, and a length that is not a
# multiple of the backward's 64-row tiles at hd=128 with GQA
FLASH_CASES = [
    dict(B=2, H=4, KV=4, S=256, hd=64, causal=True, window=0, softcap=0.0),
    dict(B=2, H=4, KV=2, S=256, hd=64, causal=True, window=64, softcap=0.0),
    dict(B=1, H=8, KV=2, S=128, hd=32, causal=True, window=0, softcap=50.0),
    dict(B=1, H=2, KV=2, S=128, hd=64, causal=False, window=0, softcap=0.0),
    dict(B=1, H=4, KV=1, S=128, hd=128, causal=True, window=32,
         softcap=30.0),
    dict(B=1, H=4, KV=2, S=256, hd=192, hd_v=128, causal=True, window=0,
         softcap=0.0),
    dict(B=1, H=2, KV=1, S=100, hd=256, causal=True, window=0, softcap=0.0),
    dict(B=4, H=24, KV=8, S=512, hd=128, causal=True, window=0, softcap=0.0),
    dict(B=2, H=4, KV=2, S=200, hd=128, causal=True, window=0, softcap=0.0),
]


# (rtol, atol) per operand dtype and output, as chip_smoke.FLASH_TOL: bf16
# o within one bf16 ulp, lse (f32 in both dtypes) within 1e-4
FLASH_TOL = {(torch.bfloat16, "o"): (1e-2, 1e-2),
             (torch.float32, "o"): (2e-5, 6e-5),
             (torch.bfloat16, "lse"): (1e-5, 1e-4),
             (torch.float32, "lse"): (1e-5, 1e-4)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci", range(len(FLASH_CASES)))
def test_flash_kernel_matches_plain(dev, ci, dtype):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    c = FLASH_CASES[ci]
    g = torch.Generator(device=dev).manual_seed(ci)
    B, S, hd = c["B"], c["S"], c["hd"]
    hd_v = c.get("hd_v", hd)
    q = torch.randn(B, c["H"], S, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, c["KV"], S, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, c["KV"], S, hd_v, generator=g, device=dev).to(dtype)
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
    blk = S if S % min(128, S) else min(128, S)
    want_o, want_lse = flash_attention_plain(q, k, v, bq=blk, bk=blk, **kw)
    reset_launches()
    o, lse = flash_attention_kernel(q, k, v, return_lse=True, **kw)
    om = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] == 2
    assert o.dtype == dtype and lse.dtype == torch.float32
    rtol, atol = FLASH_TOL[dtype, "o"]
    torch.testing.assert_close(o.float(), want_o.float(), rtol=rtol,
                               atol=atol)
    rtol, atol = FLASH_TOL[dtype, "lse"]
    torch.testing.assert_close(lse, want_lse, rtol=rtol, atol=atol)
    assert torch.equal(om.transpose(1, 2), o)


# K9's wgmma route (bf16, hd = hd_v in {64, 128}) at ragged lengths, with
# causal, window, softcap and GQA, in model layout, within FLASH_TOL
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S,causal,window,softcap,H,KV", [
    (200, True, 0, 0.0, 8, 2), (1000, True, 0, 0.0, 6, 2),
    (1000, True, 96, 0.0, 4, 4), (200, False, 0, 0.0, 4, 1),
    (1000, True, 0, 30.0, 4, 2), (333, True, 64, 50.0, 8, 1)])
def test_flash_wgmma_route_matches_plain(dev, hd, S, causal, window,
                                         softcap, H, KV):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_route)
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    assert flash_route(torch.bfloat16, hd, hd) == "wgmma"
    g = torch.Generator(device=dev).manual_seed(S + hd)
    q = torch.randn(2, S, H, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(2, S, KV, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(2, S, KV, hd, generator=g, device=dev).bfloat16()
    kw = dict(causal=causal, window=window, softcap=softcap)
    blk = S if S % min(128, S) else min(128, S)
    want_o, want_lse = flash_attention_plain(
        *(t.transpose(1, 2) for t in (q, k, v)), bq=blk, bk=blk, **kw)
    reset_launches()
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES == {"flash_attention_fwd": 1}
    rtol, atol = FLASH_TOL[torch.bfloat16, "o"]
    torch.testing.assert_close(o.transpose(1, 2).float(), want_o.float(),
                               rtol=rtol, atol=atol)
    rtol, atol = FLASH_TOL[torch.bfloat16, "lse"]
    torch.testing.assert_close(lse, want_lse, rtol=rtol, atol=atol)


def test_flash_wgmma_route_refuses_unaligned_strides(dev):
    """TMA takes 16-byte aligned bases and strides only: an operand off
    that is refused with ValueError, never sent to another kernel."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention.ops import flash_attention
    reset_launches()
    x = torch.zeros((1, 64, 2, 64 + 4), dtype=torch.bfloat16,
                    device=dev)[..., :64]
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(x, x, x)
    base = torch.zeros(1 * 64 * 2 * 64 + 4, dtype=torch.bfloat16,
                       device=dev)[4:].view(1, 64, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(base, base, base)
    assert LAUNCHES == {}


def test_flash_kernel_refuses_what_it_cannot_take(dev):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention.ops import flash_attention
    reset_launches()
    for hd in (12, 264):
        x = torch.zeros((1, 128, 2, hd), dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError, match=f"hd={hd}"):
            flash_attention(x, x, x)
    h = torch.zeros((1, 128, 2, 64), dtype=torch.float16, device=dev)
    with pytest.raises(TypeError):
        flash_attention(h, h, h)
    assert LAUNCHES == {}


def test_reduced_lm_on_card_matches_cpu(dev):
    """Reduced Phi-4-mini in f32: prefill logits through the kernel on the
    card against the plain version on the CPU, same weights."""
    import dataclasses

    import torch.utils._pytree as pytree
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import transformer as tmod
    arch = dataclasses.replace(get_arch("phi4-mini-3.8b").reduced(),
                               dtype="float32", head_dim=32)
    params = tmod.init_params(torch.Generator().manual_seed(0), arch, "cpu")
    toks = torch.randint(0, 128, (2, 128),
                         generator=torch.Generator().manual_seed(1))
    want, _ = tmod.prefill(params, arch, {"tokens": toks}, 256)
    on_card = pytree.tree_map(lambda t: t.to(dev), params)
    reset_launches()
    got, cache = tmod.prefill(on_card, arch, {"tokens": toks.to(dev)}, 256)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] == arch.n_layers
    scale = want.abs().max()
    assert (got.cpu() - want).abs().max() <= 1e-4 * scale


# K9 at the LM families' full-width prefill shapes (B, H, KV, S, hd, hd_v):
# Qwen2-MoE-A2.7B on the wgmma route, DeepSeek-V2's MLA on mma.sync
@pytest.mark.parametrize("shape,route", [
    ((4, 16, 16, 512, 128, 128), "wgmma"),
    ((4, 128, 128, 512, 192, 128), "mma_sync")])
def test_flash_kernel_matches_plain_at_lm_family_shapes(dev, shape, route):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_route)
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    B, H, KV, S, hd, hd_v = shape
    assert flash_route(torch.bfloat16, hd, hd_v) == route
    g = torch.Generator(device=dev).manual_seed(H + hd)
    q = torch.randn(B, S, H, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(B, S, KV, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(B, S, KV, hd_v, generator=g, device=dev).bfloat16()
    want_o, want_lse = flash_attention_plain(
        *(t.transpose(1, 2) for t in (q, k, v)))
    reset_launches()
    o, lse = flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert LAUNCHES == {"flash_attention_fwd": 1}
    rtol, atol = FLASH_TOL[torch.bfloat16, "o"]
    torch.testing.assert_close(o.transpose(1, 2).float(), want_o.float(),
                               rtol=rtol, atol=atol)
    rtol, atol = FLASH_TOL[torch.bfloat16, "lse"]
    torch.testing.assert_close(lse, want_lse, rtol=rtol, atol=atol)


def _moe_arch(name, dtype):
    """A reduced MoE arch whose attention head dims K9 takes: hd 32 for
    Qwen2-MoE, MLA's qk 128 + 64 and v 128 (full width's) for
    DeepSeek-V2."""
    import dataclasses

    from repro_torch.configs import MLAConfig, get_arch
    arch = dataclasses.replace(get_arch(name).reduced(), dtype=dtype,
                               head_dim=32)
    if arch.mla is not None:
        arch = dataclasses.replace(arch, mla=MLAConfig(
            kv_lora_rank=32, q_lora_rank=32, qk_nope_head_dim=128,
            qk_rope_head_dim=64, v_head_dim=128))
    return arch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "deepseek-v2-236b"])
def test_reduced_moe_archs_kernel_route_matches_plain_route(dev, name,
                                                            dtype):
    """Reduced Qwen2-MoE and DeepSeek-V2 on the card, same weights: the
    prefill logits through K9 (once a layer) against kernel mode off (the
    blockwise route), with the plain route's MoE routing forced to the
    kernel route's (``moe_routing``): a token whose top-k experts lie
    within rounding of each other may route apart in bf16.  In f32 the
    routing agrees and ``prefill``'s logits are held unforced."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import layers
    from repro_torch.models import transformer as tmod
    from torch_testdata import moe_routing
    arch = _moe_arch(name, dtype)
    params = tmod.init_params(torch.Generator(device=dev).manual_seed(0),
                              arch, dev)
    toks = torch.randint(0, 128, (4, 256), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    feed = {"tokens": toks}
    reset_launches()
    with moe_routing() as routes:
        logits, cache = tmod.prefill(params, arch, feed, 512)
    torch.cuda.synchronize()
    assert LAUNCHES == {"flash_attention_fwd": arch.n_layers}
    assert len(routes) == arch.n_layers
    layers.set_kernel_mode(False)
    try:
        plain, _ = tmod.prefill(params, arch, feed, 512)
        with moe_routing(routes):
            forced, _ = tmod.prefill(params, arch, feed, 512)
    finally:
        layers.set_kernel_mode(True)
    rel = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    scale = float(plain.abs().max())
    if dtype == "float32":
        assert (logits - plain).abs().max() <= rel * scale
    assert (logits - forced).abs().max() <= rel * scale
    assert sorted(cache) == (["c", "pe"] if arch.mla else ["k", "v"])


# (rtol, share of max|want| as atol) per operand dtype, for dq, dk and dv
# of K10/K11 against their plain version, as chip_smoke.BWD_TOL
BWD_TOL = {torch.bfloat16: (1e-2, 1e-3), torch.float32: (2e-5, 2e-6)}


def _bwd_inputs(c, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    B, S, hd = c["B"], c["S"], c["hd"]
    hd_v = c.get("hd_v", hd)
    return (torch.randn(B, c["H"], S, hd, generator=g, device=dev).to(dtype),
            torch.randn(B, c["KV"], S, hd, generator=g, device=dev).to(dtype),
            torch.randn(B, c["KV"], S, hd_v, generator=g, device=dev).to(dtype),
            torch.randn(B, c["H"], S, hd_v, generator=g, device=dev).to(dtype))


# K10/K11 at FLASH_CASES and at the shapes the LM families train at
# (chip_smoke.BWD_MAIN): DeepSeek-V2's MLA (qk 192 / v 128), Qwen2-MoE,
# SeamlessM4T's encoder (non-causal, hd 64, 1024 frames) and decoder,
# InternVL2 and Qwen2-72B, 4 x 512 tokens
BWD_CASES = FLASH_CASES + [
    dict(B=4, H=128, KV=128, S=512, hd=192, hd_v=128, causal=True, window=0,
         softcap=0.0),
    dict(B=4, H=16, KV=16, S=512, hd=128, causal=True, window=0, softcap=0.0),
    dict(B=4, H=16, KV=16, S=1024, hd=64, causal=False, window=0,
         softcap=0.0),
    dict(B=4, H=16, KV=16, S=512, hd=64, causal=True, window=0, softcap=0.0),
    dict(B=4, H=48, KV=8, S=512, hd=128, causal=True, window=0, softcap=0.0),
    dict(B=4, H=64, KV=8, S=512, hd=128, causal=True, window=0, softcap=0.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci", range(len(BWD_CASES)))
def test_flash_bwd_kernels_match_plain(dev, ci, dtype):
    """K10 (dq) and K11 (dk, dv per query head) against
    flash_attention_bwd_plain on the same forward o and lse (K9's)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_plain
    c = BWD_CASES[ci]
    q, k, v, do = _bwd_inputs(c, dtype, dev, ci)
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
    o, lse = flash_attention_kernel(q, k, v, return_lse=True, **kw)
    blk = c["S"] if c["S"] % min(128, c["S"]) else min(128, c["S"])
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, bq=blk, bk=blk,
                                     **kw)
    reset_launches()
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES == {"flash_attention_bwd_dq": 1,
                        "flash_attention_bwd_dkv": 1}
    rtol, share = BWD_TOL[dtype]
    for gt, wt in zip(got, want):
        assert gt.dtype == dtype and gt.shape == wt.shape
        torch.testing.assert_close(gt.float(), wt.float(), rtol=rtol,
                                   atol=share * float(wt.abs().max()))


# (rtol, share of max|want| as atol) for K10/K11's f32 sums against the
# plain backward on f32 casts, as chip_smoke.BWD_SUM_TOL
BWD_SUM_TOL = (1e-5, 1e-6)


@pytest.mark.parametrize("ci", [7, 4])
def test_flash_bwd_f32_sums_match_plain(dev, ci):
    """The pair on bf16 operands with f32 outputs (the sums before their
    rounding) against flash_attention_bwd_plain on the f32 casts of the
    same operands: a limit that sees a dropped part of the bf16 split of
    p and ds, which bf16 outputs hide (the training shape; softcap, GQA
    and a window)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_plain
    c = FLASH_CASES[ci]
    q, k, v, do = _bwd_inputs(c, torch.bfloat16, dev, 200 + ci)
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
    o, lse = flash_attention_kernel(q, k, v, return_lse=True, **kw)
    want = flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o)),
                                     lse, do.float(), **kw)
    reset_launches()
    got = flash_attention_bwd(q, k, v, o, lse, do, out_dtype=torch.float32,
                              **kw)
    torch.cuda.synchronize()
    assert LAUNCHES == {"flash_attention_bwd_dq": 1,
                        "flash_attention_bwd_dkv": 1}
    rtol, share = BWD_SUM_TOL
    for gt, wt in zip(got, want):
        assert gt.dtype == torch.float32 and gt.shape == wt.shape
        torch.testing.assert_close(gt, wt, rtol=rtol,
                                   atol=share * float(wt.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci", [1, 4, 7])
def test_flash_vjp_matches_autograd_through_plain(dev, ci, dtype):
    """flash_attention_vjp (K9 forward, K10/K11 backward, GQA fold) in
    model layout against autograd through the plain forward.  bf16: the
    plain forward rounds p to bf16 before PV, and autograd differentiates
    through that rounding, so 2e-2 of the max; f32 2e-5 of the max, as
    chip_smoke.VJP_REL_TOL."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention.ops import flash_attention_vjp
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    c = FLASH_CASES[ci]
    q, k, v, w = (t.transpose(1, 2).contiguous()
                  for t in _bwd_inputs(c, dtype, dev, 100 + ci))
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    o, _ = flash_attention_plain(*(t.transpose(1, 2) for t in leaves), **kw)
    want = torch.autograd.grad((o.transpose(1, 2).float() * w.float()).sum(),
                               leaves)
    reset_launches()
    o = flash_attention_vjp.apply(*leaves, c["causal"], c["window"],
                                  c["softcap"])
    got = torch.autograd.grad((o.float() * w.float()).sum(), leaves)
    torch.cuda.synchronize()
    assert LAUNCHES == {"flash_attention_fwd": 1,
                        "flash_attention_bwd_dq": 1,
                        "flash_attention_bwd_dkv": 1}
    rel = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for gt, wt in zip(got, want):
        assert gt.dtype == dtype and gt.shape == wt.shape
        assert (gt.float() - wt.float()).abs().max() <= \
            rel * wt.float().abs().max()


def test_flash_vjp_takes_a_unit_batch_gradient_of_any_stride(dev):
    """Batch 1: autograd may hand the backward a gradient whose batch
    stride is 1; K10/K11 take it (a size-1 dim's stride is never read) and
    give the grads of a gradient with the usual strides."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_vjp
    g = torch.Generator(device=dev).manual_seed(7)
    S, H, KV, hd = 256, 8, 4, 128
    q, k, v = (torch.randn(1, S, n, hd, generator=g, device=dev,
                           dtype=torch.bfloat16).requires_grad_(True)
               for n in (H, KV, KV))
    do = torch.randn(1, S, H, hd, generator=g, device=dev,
                     dtype=torch.bfloat16)
    odd = do.reshape(-1).as_strided(do.shape, (1,) + do.stride()[1:])
    grads = []
    for grad_out in (do, odd):
        o = flash_attention_vjp.apply(q, k, v, True, 0, 0.0)
        grads.append(torch.autograd.grad(o, (q, k, v), grad_out))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# K9-K11 at head dims the kernels run padded to a width they are built at
# (ops.kernel_widths; the columns past hd and hd_v zero in shared memory):
# the reduced configs' (16, 16) at 8 tokens, SeamlessM4T's non-causal
# encoder over 16 frames, DeepSeek-V2's MLA (24, 16), the training
# launcher's 64 tokens, and others between the widths and at the ends
PADDED_CASES = [
    dict(B=2, H=4, KV=2, S=8, hd=16, causal=True, window=0, softcap=0.0),
    dict(B=2, H=4, KV=4, S=16, hd=16, causal=False, window=0, softcap=0.0),
    dict(B=2, H=4, KV=4, S=8, hd=24, hd_v=16, causal=True, window=0,
         softcap=0.0),
    dict(B=8, H=4, KV=2, S=64, hd=16, causal=True, window=0, softcap=0.0),
    dict(B=8, H=4, KV=4, S=64, hd=24, hd_v=16, causal=True, window=0,
         softcap=0.0),
    dict(B=1, H=4, KV=2, S=200, hd=48, causal=True, window=64,
         softcap=30.0),
    dict(B=1, H=2, KV=1, S=130, hd=8, causal=True, window=0, softcap=0.0),
    dict(B=1, H=4, KV=2, S=100, hd=96, causal=False, window=0, softcap=0.0),
    dict(B=1, H=2, KV=2, S=77, hd=136, hd_v=200, causal=True, window=0,
         softcap=50.0),
    dict(B=1, H=2, KV=1, S=128, hd=256, hd_v=8, causal=True, window=0,
         softcap=0.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci", range(len(PADDED_CASES)))
def test_flash_kernels_at_padded_head_dims_match_plain(dev, ci, dtype):
    """K9 (o, lse) and K10/K11 (dq, dk, dv) against their plain versions
    within FLASH_TOL and BWD_TOL, on operands that are views of rows
    with NaN past hd (hd_v) and into outputs whose rows hold a sentinel
    past it: no kernel reads past a row's head dim or writes past it."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain, flash_attention_plain)
    c = PADDED_CASES[ci]
    B, H, KV, S, hd = (c[x] for x in ("B", "H", "KV", "S", "hd"))
    hd_v = c.get("hd_v", hd)
    assert ops.flash_route(dtype, hd, hd_v) == (
        "f32" if dtype == torch.float32 else "mma_sync")
    g = torch.Generator(device=dev).manual_seed(100 + ci)

    def wide(heads, d, fill=float("nan")):
        """[B, heads, S, d]: a view of rows of d + 8, the 8 past d
        ``fill``."""
        t = torch.full((B, heads, S, d + 8), fill, device=dev, dtype=dtype)
        t[..., :d] = torch.randn(B, heads, S, d, generator=g, device=dev)
        return t[..., :d]
    q, k, v, do = wide(H, hd), wide(KV, hd), wide(KV, hd_v), wide(H, hd_v)
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
    blk = S if S % min(128, S) else min(128, S)
    want_o, want_lse = flash_attention_plain(q, k, v, bq=blk, bk=blk, **kw)
    outs = [torch.full((B, H, S, d + 8), 7.0, device=dev, dtype=dtype)
            for d in (hd_v, hd, hd, hd_v)]
    o = outs[0][..., :hd_v]
    lse = torch.empty((B, H, S), device=dev)
    reset_launches()
    ops._launch(q, k, v, o, lse, **kw)
    dq, dk, dv = (t[..., :d] for t, d in zip(outs[1:], (hd, hd, hd_v)))
    ops._launch_bwd(q, k, v, do, lse, ops._delta(o, do), dq, dk, dv, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES == {"flash_attention_fwd": 1,
                        "flash_attention_bwd_dq": 1,
                        "flash_attention_bwd_dkv": 1}
    for t, d in zip(outs, (hd_v, hd, hd, hd_v)):
        assert bool((t[..., d:] == 7.0).all())
    rtol, atol = FLASH_TOL[dtype, "o"]
    torch.testing.assert_close(o.float(), want_o.float(), rtol=rtol,
                               atol=atol)
    rtol, atol = FLASH_TOL[dtype, "lse"]
    torch.testing.assert_close(lse, want_lse, rtol=rtol, atol=atol)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, bq=blk, bk=blk,
                                     **kw)
    rtol, share = BWD_TOL[dtype]
    for gt, wt in zip((dq, dk, dv), want):
        assert gt.dtype == dtype and gt.shape == wt.shape
        torch.testing.assert_close(gt.float(), wt.float(), rtol=rtol,
                                   atol=share * float(wt.abs().max()))


def test_reduced_lm_train_step_on_card_matches_cpu(dev, tmp_path):
    """Reduced Phi-4-mini in f32 (head_dim 32, so the kernels run): two
    Trainer steps on the card against the plain versions on the CPU, from
    the same weights."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenDataset
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    arch = dataclasses.replace(get_arch("phi4-mini-3.8b").reduced(),
                               dtype="float32", head_dim=32)
    import torch.utils._pytree as pytree
    from repro_torch.models import transformer as tmod
    data = TokenDataset(DataConfig(arch.vocab_size, 128, 2))
    params = tmod.init_params(torch.Generator().manual_seed(0), arch, "cpu")
    hist = {}
    for where in ("cpu", "cuda"):
        tr = Trainer(arch, TrainConfig(steps=2, log_every=1, ckpt_every=10,
                                       ckpt_path=str(tmp_path / where)),
                     data, device=where,
                     params=pytree.tree_map(lambda t: t.to(where), params))
        reset_launches()
        hist[where] = tr.run()
    torch.cuda.synchronize()
    n = arch.n_layers
    assert LAUNCHES == {"flash_attention_fwd": 2 * 2 * n,
                        "flash_attention_bwd_dq": 2 * n,
                        "flash_attention_bwd_dkv": 2 * n}
    for a, b in zip(hist["cuda"], hist["cpu"]):
        for key in ("loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= 1e-4 * abs(b[key]), (key, a, b)


# -- the fused backend (one CUDA graph per input) and CNN serving ------------


def _mini_on_card(dev, name="mini_resnet18", seed=0, batch=4, **kw):
    from repro_torch.compiler import MINI, compile
    from repro_torch.configs import cnn
    from repro_torch.models.cnn import cnn_input_shape, init_cnn_params
    cfg = getattr(cnn, name)(**kw)
    gen = torch.Generator().manual_seed(seed)
    params = init_cnn_params(cfg, gen, dev)
    x = torch.randint(-127, 128, cnn_input_shape(cfg, batch), generator=gen,
                      dtype=torch.int8).to(dev)
    return compile(cfg, MINI), params, x


@pytest.mark.parametrize("name", ["mini_resnet18", "mini_resnet50",
                                  "mini_mobilenet"])
def test_fused_replay_bit_identical_to_eager(dev, name):
    from repro_torch.kernels import LAUNCHES, reset_launches
    comp, params, x = _mini_on_card(dev, name)
    variants = [comp]
    if name == "mini_mobilenet":          # every dw layer on the HBM tier
        dw = {s.spec.name for s in comp.schedules if s.spec.kind == "dwconv"}
        variants.append(comp.with_offload(set(comp.streamed_names) | dw))
    for cp in variants:
        reset_launches()
        eager, rep_e = cp.run(params, x, backend="eager")
        torch.cuda.synchronize()
        per_forward = dict(LAUNCHES)
        first, _ = cp.run(params, x)
        reset_launches()
        warm, rep_f = cp.run(params, x)
        torch.cuda.synchronize()
        assert LAUNCHES == per_forward            # counted by the replay
        assert torch.equal(first, eager) and torch.equal(warm, eager)
        assert rep_f.layers == rep_e.layers
        rep_f.verify()
        assert cp.trace_cache_stats() == {"entries": 1, "max_entries": 8,
                                          "hits": 1, "misses": 1,
                                          "evictions": 0}


def test_fused_graph_is_bound_to_its_params(dev):
    """A graph holds its params' addresses: a second dict of the same
    shapes gets a trace of its own and its own logits, and in-place
    updates of the captured tensors are seen by the replay."""
    from repro_torch.models.cnn import init_cnn_params
    comp, params, x = _mini_on_card(dev)
    other = init_cnn_params(comp.cfg, torch.Generator().manual_seed(1), dev)
    a, _ = comp.run(params, x)
    b, _ = comp.run(other, x)
    assert comp.trace_count == 2
    assert torch.equal(b, comp.run(other, x, backend="eager")[0])
    assert not torch.equal(a, b)
    with torch.no_grad():
        for layer in params.values():
            layer["w"].copy_(torch.flip(layer["w"], dims=[0]))
    c, _ = comp.run(params, x)
    assert comp.trace_count == 2
    assert torch.equal(c, comp.run(params, x, backend="eager")[0])
    assert not torch.equal(c, a)


def test_fused_logits_survive_later_runs(dev):
    comp, params, x = _mini_on_card(dev)
    first, _ = comp.run(params, x)
    kept = first.clone()
    for _ in range(3):
        comp.run(params, torch.flip(x, dims=[0]))
    torch.cuda.synchronize()
    assert torch.equal(first, kept)


def test_fused_concurrent_runs_on_separate_streams(dev):
    """4 threads, each on a stream of its own, replaying the same traces:
    bit-identical logits and separate reports."""
    import threading
    comp, params, x = _mini_on_card(dev)
    per_image = sum(comp.plan.hbm_words_per_image().values())
    want = comp.run(params, x, backend="eager")[0]
    comp.run(params, x)
    comp.run(params, x[:2])
    results, errors = {}, []

    def worker(i):
        try:
            batch = 4 if i % 2 else 2
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                outs = [comp.run(params, x[:batch]) for _ in range(8)]
                torch.cuda.current_stream().synchronize()
            results[i] = (batch, outs)
        except Exception as e:            # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    for batch, outs in results.values():
        for logits, rep in outs:
            assert torch.equal(logits, want[:batch])
            assert rep.images == batch
            assert rep.total_hbm_words == batch * per_image
    assert comp.trace_count == 2


def test_fused_eviction_frees_device_memory(dev):
    """Churning twice through 3 x trace_cache_size batch sizes (every run
    a miss that evicts): evicted graphs and their private pools go, so
    the second churn reserves no more device memory than the first."""
    from repro_torch.compiler import MINI, compile
    comp, params, x = _mini_on_card(dev, batch=16, hw=32, width=32)
    comp = compile(comp.cfg, MINI, trace_cache_size=2)
    sizes = range(11, 17)
    want = comp.run(params, x, backend="eager")[0]
    reserved = []
    for _ in range(2):
        for b in sizes:
            got, _ = comp.run(params, x[:b])
            assert torch.equal(got, want[:b])
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(dev))
    stats = comp.trace_cache_stats()
    assert stats["entries"] == 2 and stats["misses"] == 12
    assert stats["evictions"] == 10
    assert reserved[1] <= reserved[0], reserved


def test_served_logits_bit_identical_to_eager_with_midserve_capture(dev):
    import numpy as np
    from repro_torch.kernels import LAUNCHES, reset_launches
    comp, params, x = _mini_on_card(dev, hw=8, width=16, stages=4)
    rng = np.random.default_rng(0)
    shape = tuple(x.shape[1:])
    reqs = [rng.integers(-127, 128, size=(n,) + shape, dtype=np.int8)
            for n in (1, 3, 2, 5, 1, 4, 2, 6, 3, 1)]

    def eager(r):
        return comp.run(params, torch.from_numpy(r).to(dev),
                        backend="eager")[0].cpu().numpy()

    reset_launches()
    comp.run(params, x[:4], backend="eager")
    torch.cuda.synchronize()
    per_forward = dict(LAUNCHES)
    comp.run(params, x[:4])
    reset_launches()
    with comp.serve(params, microbatch=4, credits=2) as eng:
        outs, rep = eng.serve(reqs)
    torch.cuda.synchronize()
    assert LAUNCHES == {k: v * rep.microbatches
                        for k, v in per_forward.items()}
    for got, r in zip(outs, reqs):
        assert np.array_equal(got, eager(r))
    assert eng.admission.max_in_flight_seen <= 2
    assert comp.trace_count == 1
    # the adaptive ladder: a burst, then the 1- and 2-row rungs captured
    # on the dispatcher thread mid-serve
    with comp.serve(params, microbatch=4, credits=2, adaptive=True) as eng:
        burst = [eng.submit(r) for r in reqs]
        eng.drain(timeout=300)
        singles = [eng.submit(reqs[0]).result(timeout=300),
                   eng.submit(reqs[2]).result(timeout=300)]
        rep = eng.report()
    for h, r in zip(burst, reqs):
        assert np.array_equal(h.result(), eager(r))
    for got, r in zip(singles, [reqs[0], reqs[2]]):
        assert np.array_equal(got, eager(r))
    assert {"1", "2"} <= set(rep.microbatch_shapes)
    assert comp.trace_count == 3


@pytest.mark.parametrize("name", ["mini_resnet18", "mini_resnet50"])
def test_tuned_mini_fused_bit_identical_to_eager_and_plain(dev, name):
    """``compile(..., autotune=...)`` on the card: the tuned plan's fused
    replay equals its eager walk and the plain path bit for bit, with the
    same launches and a verified Eq. 2 report; ``serve()`` takes the
    tuned credits."""
    from repro_torch.compiler import MINI, AutotuneConfig, compile
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.cnn import cnn_forward
    greedy, params, x = _mini_on_card(dev, name, hw=8, width=16, stages=4)
    cfg = greedy.cfg
    cp = compile(cfg, MINI, autotune=AutotuneConfig(iterations=60))
    assert cp.tuning is not None and cp.streamed_names
    reset_launches()
    eager, rep_e = cp.run(params, x, backend="eager")
    torch.cuda.synchronize()
    per_forward = dict(LAUNCHES)
    assert per_forward.get("conv2d_int8_stream") or \
        per_forward.get("stream_matmul_fifo")
    first, _ = cp.run(params, x)
    reset_launches()
    warm, rep_f = cp.run(params, x)
    torch.cuda.synchronize()
    assert LAUNCHES == per_forward
    plain = cnn_forward(params, cfg, x)
    assert torch.equal(eager, plain)
    assert torch.equal(first, eager) and torch.equal(warm, eager)
    assert rep_f.layers == rep_e.layers
    rep_f.verify()
    assert rep_f.total_hbm_words == \
        x.shape[0] * sum(cp.plan.hbm_words_per_image().values())
    assert cp.trace_count == 1
    eng = cp.serve(params)
    assert eng.admission.capacity == cp.tuning.serving_credits


def test_two_engine_front_end_on_card_bit_identical(dev):
    """Two engines on one card behind one front door: a tuned mini
    ResNet-50 at a fixed shape, and a mini MobileNet on the adaptive
    ladder, whose rungs are captured mid-serve while the other engine
    replays and copies.  Every request bit-identical to the eager run()
    of its images; every credit bound held and quiescent at stop."""
    import threading

    import numpy as np
    from repro_torch.compiler import MINI, AutotuneConfig, compile
    from repro_torch.runtime.frontend import MultiTenantFrontEnd
    greedy, p50, x50 = _mini_on_card(dev, "mini_resnet50", hw=8, width=16,
                                     stages=4)
    cp50 = compile(greedy.cfg, MINI, autotune=AutotuneConfig(iterations=60))
    cpmb, pmb, xmb = _mini_on_card(dev, "mini_mobilenet", seed=1)
    nets = {"r50": (cp50, p50, tuple(x50.shape[1:])),
            "mbv1": (cpmb, pmb, tuple(xmb.shape[1:]))}
    fe = MultiTenantFrontEnd(
        {"r50": cp50.serve(p50, microbatch=4, queue_depth=2),
         "mbv1": cpmb.serve(pmb, microbatch=4, queue_depth=2,
                            adaptive=True)},
        max_outstanding=4)
    fe.register_tenant("light", network="r50", weight=1.0)
    fe.register_tenant("heavy", network="r50", weight=4.0)
    fe.register_tenant("bulk", network="mbv1", weight=8.0)
    fe.register_tenant("rt", network="mbv1", weight=1.0, deadline_ms=0.0)
    net_of = {"light": "r50", "heavy": "r50", "bulk": "mbv1", "rt": "mbv1"}
    rng = np.random.default_rng(0)
    traffic = {t: [rng.integers(-127, 128, size=(int(n),)
                                + nets[net_of[t]][2], dtype=np.int8)
                   for n in rng.integers(1, 5, 12)] for t in net_of}
    handles, errors = {}, []

    def producer(t):
        try:
            handles[t] = [fe.submit(t, r) for r in traffic[t]]
        except Exception as e:                # surfaced below
            errors.append(e)

    with fe:
        threads = [threading.Thread(target=producer, args=(t,))
                   for t in net_of]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
        assert not errors, errors
        fe.drain(timeout=300)
        rep = fe.report()
    fe.admission.assert_quiescent()
    assert fe.admission.max_in_flight_seen <= 4
    for net, lane in fe._lanes.items():
        lane.engine.admission.assert_quiescent()
    for t, reqs in handles.items():
        cp, params, _ = nets[net_of[t]]
        for h, r in zip(reqs, traffic[t]):
            want = cp.run(params, torch.from_numpy(r).to(dev),
                          backend="eager")[0].cpu().numpy()
            assert np.array_equal(h.result(), want), t
    assert rep.requests == 48 and rep.promotions > 0
    assert cpmb.trace_count >= 2


@pytest.mark.parametrize("name", ["mini_resnet18", "mini_resnet50"])
def test_sharded_ring_on_card_bit_identical_over_many_rounds(dev, name):
    """Four stages on ``cuda:0``'s streams, 250 rounds or more of short
    rounds (3 microbatches of 2) from two producers: every request
    bit-identical to the eager ``run()``.  A ring that overwrote a
    boundary buffer before the next stage consumed it would corrupt some
    request here.  Launches: (microbatches + empty slots) x the stage
    graphs' launches, which sum to one forward's."""
    import threading

    import numpy as np
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import compat_make_mesh
    comp, params, x = _mini_on_card(dev, name, hw=8, width=16, stages=4)
    S = 4
    mesh = compat_make_mesh((S,), ("model",), devices=["cuda:0"] * S)
    rng = np.random.default_rng(0)
    shape = tuple(x.shape[1:])
    reqs = [rng.integers(-127, 128, size=(int(n),) + shape, dtype=np.int8)
            for n in rng.integers(1, 6, 500)]
    big = np.concatenate(reqs)
    ref = np.concatenate([
        comp.run(params, torch.from_numpy(big[i:i + 64]).to(dev),
                 backend="eager")[0].cpu().numpy()
        for i in range(0, len(big), 64)])
    reset_launches()
    comp.run(params, x[:2], backend="eager")
    torch.cuda.synchronize()
    per_forward = dict(LAUNCHES)
    handles = [None] * len(reqs)
    with comp.serve_sharded(params, mesh=mesh, microbatch=2,
                            round_microbatches=3) as eng:
        per_mb = {}
        for prog in eng.stage_programs:
            for k, v in prog.runner.launches.counts.items():
                per_mb[k] = per_mb.get(k, 0) + v
        assert per_mb == per_forward
        assert len({id(st) for st in eng._ring.streams}) == S
        reset_launches()

        def producer(pid):
            for i in range(pid, len(reqs), 2):
                handles[i] = eng.submit(reqs[i])
        threads = [threading.Thread(target=producer, args=(p,))
                   for p in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            assert not t.is_alive()
        eng.drain(timeout=600)
        rep = eng.report()
    torch.cuda.synchronize()
    eng.admission.assert_quiescent()
    assert rep.rounds >= 250 and rep.max_in_flight <= rep.credits
    assert LAUNCHES == {k: v * (rep.microbatches + rep.empty_microbatches)
                        for k, v in per_mb.items()}
    off = 0
    for i, (h, r) in enumerate(zip(handles, reqs)):
        assert np.array_equal(h.result(), ref[off:off + len(r)]), i
        off += len(r)
    assert comp.trace_count == 0          # the stage graphs stay the engine's


SHARDED_CAPTURE_FAILURES = """
import sys
import torch
from repro_torch.compiler import (MINI, compile, get_engine,
                                  register_engine, unregister_engine)
from repro_torch.configs.cnn import mini_resnet18
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models.cnn import init_cnn_params

cfg = mini_resnet18(hw=8, width=16, stages=4)
params = init_cnn_params(cfg, torch.Generator().manual_seed(0), "cuda")
mesh = compat_make_mesh((4,), ("model",), devices=["cuda:0"] * 4)
builtin = get_engine("stream_matmul")


def fc_engine(name, run):
    @register_engine(name, priority=99)
    class Engine:
        def supports(self, spec):
            return builtin.supports(spec)

        def vmem_bytes(self, spec, sched):
            return builtin.vmem_bytes(spec, sched)

        def stats(self, sched, batch):
            return builtin.stats(sched, batch)

        def run(self, ctx, sched, p, xx, relu):
            return run(ctx, sched, p, xx, relu)


def expect_start_to_raise(what, match):
    cp = compile(cfg, MINI)
    eng = cp.serve_sharded(params, mesh=mesh, microbatch=2)
    try:
        eng.start()
    except RuntimeError as e:
        msg = str(e)
    else:
        sys.exit(f"{what}: start() did not raise")
    assert match in msg, (what, msg)
    assert not eng._started and eng._ring is None and not eng.stage_programs
    try:
        eng.submit(torch.zeros((1, 8, 8, 3), dtype=torch.int8).numpy())
    except RuntimeError as e:
        assert "not started" in str(e)
    else:
        sys.exit(f"{what}: a request was taken")
    print(what, "raised:", msg[:80])


# the fc head adds how often it ran: the eager walk adds 1, the capture
# bakes in 2, so the first replay differs from the eager walk
calls = [0]


def drift(ctx, sched, p, xx, relu):
    calls[0] += 1
    y_q, y_f, st = builtin.run(ctx, sched, p, xx, relu)
    return y_q, y_f + float(calls[0]), st


fc_engine("fc_drift", drift)
try:
    expect_start_to_raise("replay differs", "differs from the eager walk")
finally:
    unregister_engine("fc_drift")


def host_sync(ctx, sched, p, xx, relu):
    xx.float().sum().item()                    # cannot be captured
    return builtin.run(ctx, sched, p, xx, relu)


fc_engine("fc_sync", host_sync)
try:
    expect_start_to_raise("capture fails", "")
finally:
    unregister_engine("fc_sync")
print("OK")
"""


def test_sharded_capture_failure_or_unequal_replay_raises_from_start(dev):
    """A stage graph whose first replay differs from the eager walk of its
    stage, and a stage that cannot be captured, both raise from
    ``start()``: no ring, no request taken, nothing falls back to the
    eager walk.  In a process of its own, since a failed capture may
    leave the context unusable."""
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run([sys.executable, "-c", SHARDED_CAPTURE_FAILURES],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert r.stdout.strip().endswith("OK"), r.stdout


def test_fused_capture_failure_raises(dev):
    """An engine that syncs with the host cannot be captured: run() raises
    and caches nothing; nothing falls back to the eager walk.  Last in
    the file, since a failed capture may leave the context unusable."""
    from repro_torch.compiler import get_engine, register_engine
    from repro_torch.compiler import unregister_engine
    comp, params, x = _mini_on_card(dev)
    builtin = get_engine("stream_matmul")

    @register_engine("fc_sync", priority=99)
    class SyncingFCEngine:
        def supports(self, spec):
            return builtin.supports(spec)

        def vmem_bytes(self, spec, sched):
            return builtin.vmem_bytes(spec, sched)

        def stats(self, sched, batch):
            return builtin.stats(sched, batch)

        def run(self, ctx, sched, p, xx, relu):
            xx.float().sum().item()               # a host sync
            return builtin.run(ctx, sched, p, xx, relu)

    try:
        from repro_torch.compiler import MINI, compile
        syncing = compile(comp.cfg, MINI)
        assert syncing.engine_table()["fc"] == "fc_sync"
        with pytest.raises(RuntimeError):
            syncing.run(params, x)
        assert syncing.trace_count == 0
    finally:
        assert unregister_engine("fc_sync") is not None


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "vgg16",
                                  "mobilenetv1", "mobilenetv2",
                                  "mobilenetv3"])
def test_h100_compiled_layers_match_plain(dev, name):
    """Every layer of the net compiled for ``H100`` launched through its
    engine at batch 8, in the tier stage 5 checked, against the plain
    reference engine on the same inputs: int8 (and the fc heads' f32)
    outputs bit-identical, one launch a layer."""
    from repro_torch.compiler import H100, compile, get_engine, select_engine
    from repro_torch.compiler.engines import EngineContext
    from repro_torch.configs.cnn import get_cnn
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.cnn import init_conv_layer
    cp = compile(get_cnn(name), H100)
    ctx = EngineContext(act_scale=0.05)
    ref = get_engine("jnp_ref")
    g = torch.Generator().manual_seed(7)
    last = cp.cfg.layers[-1].name
    for s in cp.plan.schedules:
        sp = s.spec
        eng = select_engine(sp)
        x = torch.randint(-127, 128, (8, sp.in_h, sp.in_w, sp.c_in),
                          generator=g, dtype=torch.int8).to(dev)
        p = {} if sp.is_pool else init_conv_layer(sp, g, dev)
        reset_launches()
        got_q, got_f, _ = eng.run(ctx, s, p, x, sp.name != last)
        torch.cuda.synchronize()
        assert sum(LAUNCHES.values()) == 1, (sp.name, LAUNCHES)
        want_q, want_f, _ = ref.run(ctx, s, p, x, sp.name != last)
        assert torch.equal(got_q, want_q), sp.name
        if got_f is not None:
            assert torch.equal(got_f, want_f), sp.name


def test_wide_conv_launch_raises_under_nx2100_and_streams_under_h100(dev):
    """A 3x3 conv, C 2048 -> 16, that no pinned launch plan fits: compiled
    for NX2100 (pinned, as the working-set check allows) its launch
    raises; compiled for H100 stage 5 streams it, and the run equals the
    plain path bit for bit."""
    from repro_torch.compiler import H100, NX2100, compile
    from repro_torch.configs import cnn
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.cnn import (cnn_forward, cnn_input_shape,
                                        init_cnn_params)
    from torch_testdata import wide_conv_cfg
    cfg = wide_conv_cfg(cnn)
    gen = torch.Generator().manual_seed(8)
    params = init_cnn_params(cfg, gen, dev)
    x = torch.randint(-127, 128, cnn_input_shape(cfg, 8), generator=gen,
                      dtype=torch.int8).to(dev)
    pinned = compile(cfg, NX2100)
    assert pinned.streamed_names == ()
    with pytest.raises(ValueError, match="shared memory"):
        pinned.run(params, x)
    streamed = compile(cfg, H100)
    assert streamed.streamed_names == ("wide",)
    reset_launches()
    got, rep = streamed.run(params, x, backend="eager")
    torch.cuda.synchronize()
    assert LAUNCHES.get("conv2d_int8_stream") == 1
    assert torch.equal(got, cnn_forward(params, cfg, x))
    fused, _ = streamed.run(params, x)
    assert torch.equal(fused, got)
    rep.verify()
