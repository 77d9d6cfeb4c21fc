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
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.stream_matmul.ops import stream_matmul
    reset_launches()
    x = torch.ones(8, 64, device=dev)
    w = torch.ones(64, 32, device=dev)
    for a, b in ((x.half(), w.half()), (x, w.half()), (x.double(), w),
                 (x.to(torch.int8), w), (x, w.to(torch.int8))):
        with pytest.raises(NotImplementedError, match="not torch"):
            stream_matmul(a, b)
    assert LAUNCHES == {}


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
    x = torch.zeros((1, 128, 2, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="hd=96"):
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci", range(len(FLASH_CASES)))
def test_flash_bwd_kernels_match_plain(dev, ci, dtype):
    """K10 (dq) and K11 (dk, dv per query head) against
    flash_attention_bwd_plain on the same forward o and lse (K9's)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_plain
    c = FLASH_CASES[ci]
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
