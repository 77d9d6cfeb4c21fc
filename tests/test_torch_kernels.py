"""The port's plain kernel versions against the JAX package's Pallas
kernels (interpret mode), bit for bit on the int8 paths.

Inputs are made with numpy from a seed and handed to both frameworks.
The CUDA kernels themselves are held against these plain versions on the
card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d_int8.ops import conv2d_int8 as jax_conv
from repro.kernels.pool_int8.ops import (global_avgpool_int8 as jax_gap,
                                         maxpool_int8 as jax_maxpool)
from repro.kernels.quant import requant_epilogue as jax_requant
from repro.kernels.stream_matmul.ops import stream_matmul as jax_matmul
from repro_torch.kernels.conv2d_int8.ops import (conv2d_int8,
                                                 conv2d_int8_requant)
from repro_torch.kernels.pool_int8.ops import (global_avgpool_int8,
                                               maxpool_int8)
from repro_torch.kernels.quant import requant_epilogue
from repro_torch.kernels.stream_matmul.ops import (stream_matmul,
                                                   stream_matmul_requant)


def _int8(rng, shape):
    return rng.integers(-127, 128, size=shape, dtype=np.int8)


def _same(got: torch.Tensor, want) -> None:
    want = np.array(want)
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)


# (k, stride, C_in, tiers): every tier list covers the pinned kernel and
# the streamed ring; the 3x3 case sweeps n_buffers over 1..k*k.  (The 1x1
# cases take C_in=16: XLA's CPU compiler rejects the interpret-mode
# program of a 1x1 stride-2 kernel at C_in=8.)
CONV_CASES = [
    (1, 1, 16, (None, 2)),
    (1, 2, 16, (None, 1)),
    (3, 1, 8, (None, 1, 2, 3, 5, 9)),
    (3, 2, 8, (None, 2)),
    (3, 1, 3, (None, 2)),
    (7, 2, 3, (None, 49)),
]


@pytest.mark.parametrize(
    "k,stride,c_in,nb",
    [(k, s, c, nb) for k, s, c, tiers in CONV_CASES for nb in tiers],
    ids=lambda v: "pinned" if v is None else str(v))
def test_conv_matches_pallas(k, stride, c_in, nb):
    rng = np.random.default_rng(100 * k + 10 * stride + c_in)
    x = _int8(rng, (2, 9, 11, c_in))            # odd maps: asymmetric pads
    w = _int8(rng, (k, k, c_in, 8))
    stream = nb is not None
    n_buffers = nb or 2
    want = jax_conv(jnp.asarray(x), jnp.asarray(w), stride=stride,
                    stream=stream, n_buffers=n_buffers, interpret=True)
    got = conv2d_int8(torch.from_numpy(x), torch.from_numpy(w),
                      stride=stride, stream=stream, n_buffers=n_buffers)
    _same(got, want)


@pytest.mark.parametrize("relu", [True, False])
def test_conv_requant_matches_pallas(relu):
    from repro.kernels.conv2d_int8.ops import conv2d_int8_requant as jax_cr
    rng = np.random.default_rng(7)
    x = _int8(rng, (2, 8, 8, 16))
    w = _int8(rng, (3, 3, 16, 12))
    w_scale = rng.uniform(0.01, 0.1, 12).astype(np.float32)
    bias = rng.normal(0, 5, 12).astype(np.float32)
    want = jax_cr(jnp.asarray(x), jnp.asarray(w), jnp.asarray(w_scale),
                  jnp.asarray(bias), 0.05, stride=1, relu=relu, stream=True,
                  n_buffers=2, interpret=True)
    got, _ = conv2d_int8_requant(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(w_scale),
        torch.from_numpy(bias), 0.05, stride=1, relu=relu, stream=True)
    _same(got, want)


# (x shape, k, stride, tier): k in {3, 5} x stride in {1, 2} x (pinned,
# streamed with n_buffers in {1, 2, k*k}), on an odd map with C=8 (the
# original pinned case) and an even map with C=16.
DW_CASES = [(shape, k, stride, nb)
            for shape in ((2, 7, 9, 8), (2, 8, 6, 16))
            for k in (3, 5) for stride in (1, 2)
            for nb in (None, 1, 2, k * k)]


@pytest.mark.parametrize(
    "shape,k,stride,nb", DW_CASES,
    ids=lambda v: ("x".join(map(str, v)) if isinstance(v, tuple)
                   else "pinned" if v is None else str(v)))
def test_depthwise_matches_pallas(shape, k, stride, nb):
    rng = np.random.default_rng(1000 * k + 100 * stride + shape[-1])
    x = _int8(rng, shape)
    w = _int8(rng, (k, k, 1, shape[-1]))
    w_scale = rng.uniform(0.01, 0.1, shape[-1]).astype(np.float32)
    bias = rng.normal(0, 5, shape[-1]).astype(np.float32)
    stream = nb is not None
    n_buffers = nb or 2
    y = jax_conv(jnp.asarray(x), jnp.asarray(w), stride=stride,
                 stream=stream, n_buffers=n_buffers, depthwise=True,
                 interpret=True)
    want_q, want_f = jax.jit(jax_requant, static_argnames=(
        "act_scale", "relu"))(y, jnp.asarray(w_scale), jnp.asarray(bias),
                              act_scale=0.05, relu=True)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = conv2d_int8(xt, wt, stride=stride, stream=stream,
                      n_buffers=n_buffers, depthwise=True)
    _same(got, y)
    got_q, got_f = conv2d_int8_requant(
        xt, wt, torch.from_numpy(w_scale), torch.from_numpy(bias), 0.05,
        stride=stride, relu=True, stream=stream, n_buffers=n_buffers,
        depthwise=True, want_float=True)
    _same(got_q, want_q)
    _same(got_f, want_f)


@pytest.mark.parametrize("k,stride,hw", [(3, 2, (9, 8)), (3, 2, (8, 8)),
                                         (2, 2, (7, 7)), (3, 1, (5, 6))])
def test_maxpool_matches_pallas(k, stride, hw):
    rng = np.random.default_rng(k * stride + hw[0])
    x = _int8(rng, (2, *hw, 8))
    x[0, 0, 0, :] = -128                     # the padding value itself
    want = jax_maxpool(jnp.asarray(x), k=k, stride=stride, interpret=True)
    _same(maxpool_int8(torch.from_numpy(x), k=k, stride=stride), want)


@pytest.mark.parametrize("shape,act_scale", [((2, 7, 7, 16), 0.05),
                                             ((1, 3, 5, 8), 0.1),
                                             ((3, 1, 1, 4), 0.05)])
def test_gap_matches_pallas(shape, act_scale):
    rng = np.random.default_rng(shape[1] * shape[2])
    x = _int8(rng, shape)
    want = jax_gap(jnp.asarray(x), act_scale=act_scale, interpret=True)
    _same(global_avgpool_int8(torch.from_numpy(x), act_scale=act_scale),
          want)


@pytest.mark.parametrize("mode,n_buffers", [("pinned", 2), ("stream", 2),
                                            ("fifo", 2), ("fifo", 3)])
def test_matmul_int8_matches_pallas(mode, n_buffers):
    rng = np.random.default_rng(n_buffers)
    x, w = _int8(rng, (8, 64)), _int8(rng, (64, 32))
    want = jax_matmul(jnp.asarray(x), jnp.asarray(w), mode=mode, bm=8,
                      bk=16, bn=16, n_buffers=n_buffers, interpret=True)
    got = stream_matmul(torch.from_numpy(x), torch.from_numpy(w), mode=mode,
                        bk=16, n_buffers=n_buffers)
    _same(got, want)


@pytest.mark.parametrize("mode", ["pinned", "stream", "fifo"])
def test_matmul_f32_matches_pallas(mode):
    # f32 at rtol 1e-5: the Pallas kernel sums K-blocks in f32, the plain
    # version in float64, so the last bits may differ
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    want = jax_matmul(jnp.asarray(x), jnp.asarray(w), mode=mode, bm=8,
                      bk=16, bn=16, n_buffers=3, interpret=True)
    got = stream_matmul(torch.from_numpy(x), torch.from_numpy(w), mode=mode,
                        bk=16, n_buffers=3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_matmul_requant_matches_pallas_plus_epilogue():
    rng = np.random.default_rng(11)
    x, w = _int8(rng, (8, 128)), _int8(rng, (128, 12))
    w_scale = np.full(12, 0.05, np.float32)
    bias = rng.normal(0, 3, 12).astype(np.float32)
    y = jax_matmul(jnp.asarray(x), jnp.asarray(w), mode="fifo", bm=8,
                   bk=32, bn=12, n_buffers=2, interpret=True)
    want_q, want_f = jax.jit(jax_requant, static_argnames=(
        "act_scale", "relu"))(y, jnp.asarray(w_scale), jnp.asarray(bias),
                              act_scale=0.05, relu=False)
    got_q, got_f = stream_matmul_requant(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(w_scale),
        torch.from_numpy(bias), 0.05, relu=False, mode="fifo", bk=32)
    _same(got_q, want_q)
    _same(got_f, want_f)


def _tie_rich_accumulators(rng, n):
    """Every int32 sum in [-4n, 4n) (so every residue that lands on a .5
    tie under the scales below), then random sums over the main path's
    range."""
    ties = np.arange(-4 * n, 4 * n, dtype=np.int32)
    wide = rng.integers(-2 ** 26, 2 ** 26, size=n, dtype=np.int32)
    return np.concatenate([ties, wide]).reshape(-1, 8)


@pytest.mark.parametrize("w_scale,act_scale,bias_scale,relu", [
    (0.5, 0.5, 0.0, False),         # y/4 / 0.5 = y/2: ties on odd y
    (0.5, 0.5, 0.25, True),         # bias on the quarter grid: more ties
    (0.05, 0.05, 0.0, True),        # the model's scales
    (0.05, 0.05, 3.0, False),       # random bias: double rounding possible
    (0.0123, 0.07, 1.0, False),
])
def test_requant_epilogue_matches_jitted_reference(w_scale, act_scale,
                                                   bias_scale, relu):
    rng = np.random.default_rng(int(w_scale * 1e4) + int(bias_scale * 10))
    y = _tie_rich_accumulators(rng, 4096)
    ws = np.full(8, w_scale, np.float32)
    if bias_scale == 0.25:
        bias = (rng.integers(-8, 8, size=8) * 0.25).astype(np.float32)
    else:
        bias = (rng.normal(size=8) * bias_scale).astype(np.float32)
    want_q, want_f = jax.jit(jax_requant, static_argnames=(
        "act_scale", "relu"))(jnp.asarray(y), jnp.asarray(ws),
                              jnp.asarray(bias), act_scale=act_scale,
                              relu=relu)
    got_q, got_f = requant_epilogue(torch.from_numpy(y), torch.from_numpy(ws),
                                    torch.from_numpy(bias),
                                    act_scale=act_scale, relu=relu)
    _same(got_q, want_q)
    _same(got_f, want_f)
