"""The port's plain flash-attention forward (K9) against the JAX package's
Pallas kernel in interpret mode, and against the port's own oracle; the
exact three-way bf16 split that the tensor-core backward (K10, K11)
multiplies, and the plain backward computed through it against the JAX
backward kernels; and the forward's route (``flash_route``) for each
(dtype, hd, hd_v).

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances are those of ``tests/test_kernels.py::test_flash_attention``:
rtol 2e-5 / atol 6e-5 in f32 and rtol 2e-2 / atol 6e-2 in bf16 (bf16
rounds p before the PV product, in another block order).  The CUDA kernel
is held against this plain version on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_bwd \
    as jax_flash_bwd
from repro.kernels.flash_attention.kernel import flash_attention_kernel \
    as jax_flash_kernel
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention.ops import (KERNEL_HD, KERNEL_HD_V,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_kernel,
                                                     flash_route)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain, flash_attention_plain, flash_attention_ref,
    split3_bf16)

# the five ATTN_CASES of tests/test_kernels.py, then one hd != hd_v case
CASES = [
    dict(B=2, H=4, KV=4, S=256, hd=64, causal=True, window=0, softcap=0.0),
    dict(B=2, H=4, KV=2, S=256, hd=64, causal=True, window=64, softcap=0.0),
    dict(B=1, H=8, KV=2, S=128, hd=32, causal=True, window=0, softcap=50.0),
    dict(B=1, H=2, KV=2, S=128, hd=64, causal=False, window=0, softcap=0.0),
    dict(B=1, H=4, KV=1, S=128, hd=128, causal=True, window=32,
         softcap=30.0),
    dict(B=1, H=4, KV=2, S=128, hd=192, hd_v=128, causal=True, window=0,
         softcap=0.0),
]
DTYPES = {"f32": (torch.float32, jnp.float32, 2e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(case, seed):
    """q [B,S,H,hd], k [B,S,KV,hd], v [B,S,KV,hd_v] as f32 numpy."""
    rng = np.random.default_rng(seed)
    B, S = case["B"], case["S"]
    hd_v = case.get("hd_v", case["hd"])
    return (rng.standard_normal((B, S, case["H"], case["hd"]), np.float32),
            rng.standard_normal((B, S, case["KV"], case["hd"]), np.float32),
            rng.standard_normal((B, S, case["KV"], hd_v), np.float32))


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 3)


def _kw(case):
    return dict(causal=case["causal"], window=case["window"],
                softcap=case["softcap"])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_plain_matches_pallas_model_layout(ci, dtype):
    case = CASES[ci]
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v = _inputs(case, ci)
    want = jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                     interpret=True, **_kw(case))
    reset_launches()
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          **_kw(case))
    assert LAUNCHES == {}                  # CPU tensors launch nothing
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    _close(got, want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_plain_lse_matches_pallas_kernel(ci, dtype):
    case = CASES[ci]
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v = (a.transpose(0, 2, 1, 3) for a in _inputs(case, 100 + ci))
    want_o, want_lse = jax_flash_kernel(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), return_lse=True,
        interpret=True, **_kw(case))
    got_o, got_lse = flash_attention_kernel(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(tdt)
          for a in (q, k, v)), return_lse=True, **_kw(case))
    assert got_lse.dtype == torch.float32
    _close(got_o, want_o, tol)
    _close(got_lse, want_lse, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_plain_blocks_match_pallas_blocks(ci, dtype):
    """At blocks of 64 on both sides (another order of summation than
    the default blocks')."""
    case = CASES[ci]
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v = (a.transpose(0, 2, 1, 3) for a in _inputs(case, 300 + ci))
    want_o, want_lse = jax_flash_kernel(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), bq=64, bk=64,
        return_lse=True, interpret=True, **_kw(case))
    got_o, got_lse = flash_attention_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(tdt)
          for a in (q, k, v)), bq=64, bk=64, **_kw(case))
    _close(got_o, want_o, tol)
    _close(got_lse, want_lse, tol)


@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 32), (32, 128)])
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_plain_matches_oracle(ci, bq, bk):
    """The block loop equals the materialised softmax whatever the blocks
    (f32, where only the summation order differs)."""
    case = CASES[ci]
    q, k, v = (torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
               for a in _inputs(case, 200 + ci))
    got, _ = flash_attention_plain(q, k, v, bq=bq, bk=bk, **_kw(case))
    want = flash_attention_ref(q, k, v, **_kw(case))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=6e-5)


def test_plain_rejects_ragged_blocks():
    q = torch.zeros((1, 2, 100, 32))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_plain(q, q, q, bq=64, bk=64)


# ---------------------------------------------------------------------------
# the exact three-way bf16 split of the backward's p and ds
# ---------------------------------------------------------------------------


def _split_inputs(kind: str, n: int = 1 << 16) -> torch.Tensor:
    rng = np.random.default_rng(len(kind))
    if kind == "p":             # softmax probabilities
        x = rng.uniform(0.0, 1.0, n)
    elif kind == "ds":          # both signs, magnitudes e^-24 .. e^24
        x = rng.choice([-1.0, 1.0], n) * np.exp(rng.uniform(-24, 24, n))
    elif kind == "zeros":
        x = np.zeros(n)
    else:                       # near 2^-100, both signs
        x = rng.choice([-1.0, 1.0], n) * np.ldexp(rng.uniform(1, 2, n), -100)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind", ["p", "ds", "zeros", "tiny"])
def test_split3_reconstructs_bit_for_bit(kind):
    x = _split_inputs(kind)
    parts = split3_bf16(x)
    assert all(t.dtype == torch.bfloat16 for t in parts)
    hi, mid, lo = (t.float() for t in parts)
    assert torch.equal((lo + mid) + hi, x)
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    # each part holds what the one above could not: a two-way split is
    # not exact on these inputs (except zeros)
    assert (lo.abs() <= mid.abs() * 2 ** -8).all()
    assert (mid.abs() <= hi.abs() * 2 ** -8).all()
    if kind != "zeros":
        assert not torch.equal(mid + hi, x)


# (max |diff| as a share of max |want|) per dtype, as test_torch_train.py's
# KERNEL_REL for the plain backward against the JAX backward kernels
BWD_REL = {"f32": 1e-5, "bf16": 1e-2}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_bwd_plain_through_split_matches_pallas(ci, dtype):
    """The plain backward with its three accumulating products taken
    through split3_bf16 (bf16 parts cast to f32, one product each, as the
    tensor-core kernels run them) against the JAX backward kernels on the
    same q, k, v, do and forward o, lse."""
    case = CASES[ci]
    tdt, jdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(400 + ci)
    B, H, KV, S, hd = (case[x] for x in ("B", "H", "KV", "S", "hd"))
    hd_v = case.get("hd_v", hd)
    q, k, v, do = (rng.standard_normal(shape, np.float32) for shape in (
        (B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd_v), (B, H, S, hd_v)))
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    o, lse = jax_flash_kernel(jq, jk, jv, return_lse=True, interpret=True,
                              **_kw(case))
    rep = H // KV
    want = jax_flash_bwd(jq, jnp.repeat(jk, rep, 1), jnp.repeat(jv, rep, 1),
                         o, lse, jdo, interpret=True, **_kw(case))
    args = [torch.from_numpy(np.array(a, np.float32)).to(tdt)
            for a in (jq, jk, jv, o)]
    lse_t = torch.from_numpy(np.array(lse))
    do_t = torch.from_numpy(np.array(jdo, np.float32)).to(tdt)
    got = flash_attention_bwd_plain(*args, lse_t, do_t, split3=True,
                                    **_kw(case))
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        err = np.abs(g.float().numpy() - w).max()
        assert err <= BWD_REL[dtype] * np.abs(w).max(), (err, np.abs(w).max())
    # the f32 sums through the split equal those of f32 products but for
    # the order of f32 additions and the scale taken per element
    unsplit = flash_attention_bwd(*args, lse_t, do_t,
                                  out_dtype=torch.float32, **_kw(case))
    split = flash_attention_bwd_plain(*args, lse_t, do_t, split3=True,
                                      out_dtype=torch.float32, **_kw(case))
    for g, w in zip(split, unsplit):
        assert g.dtype == torch.float32
        assert (g - w).abs().max() <= 1e-6 * w.abs().max()


def test_bwd_f32_grads_only_from_bf16():
    """f32 grads come from 16-bit operands (bf16, and f16 since it runs
    on the card: ``tests/test_torch_flash_f16.py``); f32 operands give
    f32 grads and refuse any other."""
    q = torch.zeros((1, 2, 64, 32))
    lse = torch.zeros((1, 2, 64))
    with pytest.raises(TypeError, match="bf16 or f16 operands"):
        flash_attention_bwd(q, q, q, q, lse, q, out_dtype=torch.bfloat16)
    h = q.half()
    assert all(g.dtype == torch.float32 for g in flash_attention_bwd(
        h, h, h, h, lse, h, out_dtype=torch.float32))


# the forward's route from (dtype, hd, hd_v) alone: every pair of the
# widths the bf16 kernels are built at, in both dtypes (every other
# multiple of 8: tests/test_torch_reduced_heads.py)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", KERNEL_HD)
@pytest.mark.parametrize("hd_v", KERNEL_HD_V)
def test_flash_route_of_each_head_dim_pair(dtype, hd, hd_v):
    route = flash_route(dtype, hd, hd_v)
    if dtype == torch.float32:
        assert route == "f32"
    elif hd == hd_v and hd in (64, 128):
        assert route == "wgmma"
    else:
        assert route == "mma_sync"


@pytest.mark.parametrize("dtype,hd,hd_v,err", [
    (torch.float64, 128, 128, TypeError), (torch.bfloat16, 264, 264,
                                           ValueError),
    (torch.bfloat16, 128, 264, ValueError), (torch.float32, 0, 64,
                                             ValueError)])
def test_flash_route_refuses_what_no_kernel_takes(dtype, hd, hd_v, err):
    """What stays refused: f64, and head dims outside 1 to 256.  f16 and
    head dims off the multiples of 8 (12, say) have routes now
    (``tests/test_torch_flash_f16.py``)."""
    with pytest.raises(err):
        flash_route(dtype, hd, hd_v)
    assert flash_route(torch.float16, 128, 128) == "wgmma"
    assert flash_route(torch.bfloat16, 12, 12) == "mma_sync"
    assert flash_route(torch.float32, 12, 64) == "f32"


def test_phi4_mini_takes_the_wgmma_route():
    from repro_torch.configs import get_arch
    arch = get_arch("phi4-mini-3.8b")
    assert flash_route(torch.bfloat16, arch.head_dim, arch.head_dim) == \
        "wgmma"


def test_kernel_strides_align_a_unit_batch():
    """A gradient of batch 1 may come with stride 1 on its batch dim
    (``contiguous()`` ignores a size-1 dim's stride); the kernels are
    given the span there, which TMA takes, and the other strides as
    they are."""
    from repro_torch.kernels.flash_attention.ops import kernel_strides
    S, H, hd = 64, 4, 32
    g = torch.zeros(S * H * hd).as_strided((1, S, H, hd), (1, H * hd, hd, 1))
    assert g.is_contiguous()
    t = g.transpose(1, 2)                       # the kernel layout
    assert kernel_strides(t) == (S * H * hd, hd, H * hd, 1)
    x = torch.zeros(2, S, H, hd).transpose(1, 2)
    assert kernel_strides(x) == x.stride()


# ---------------------------------------------------------------------------
# the backward's route (flash_bwd_route), and the wgmma kernels' shared
# memory and fragments (csrc/flash_attention_bwd.cu, flash_bwd_*_wgmma)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("hd", KERNEL_HD)
@pytest.mark.parametrize("hd_v", KERNEL_HD_V)
def test_flash_bwd_route_of_each_head_dim_pair(dtype, hd, hd_v):
    """K10/K11 take wgmma for bf16 at hd = hd_v in {64, 128} only: f16
    stays on mma.sync everywhere (its accumulating products run on tf32),
    f32 on the CUDA cores; the forward's route is unchanged."""
    from repro_torch.kernels.flash_attention.ops import flash_bwd_route
    route = flash_bwd_route(dtype, hd, hd_v)
    if dtype == torch.float32:
        assert route == "f32"
    elif dtype == torch.bfloat16 and hd == hd_v and hd in (64, 128):
        assert route == "wgmma"
    else:
        assert route == "mma_sync"
    fwd = flash_route(dtype, hd, hd_v)
    assert route == fwd or (dtype == torch.float16 and fwd == "wgmma")


@pytest.mark.parametrize("dtype,hd,hd_v,err", [
    (torch.float64, 128, 128, TypeError), (torch.int8, 64, 64, TypeError),
    (torch.bfloat16, 264, 264, ValueError),
    (torch.bfloat16, 128, 0, ValueError), (torch.float32, 0, 64,
                                           ValueError)])
def test_flash_bwd_route_refuses_what_no_kernel_takes(dtype, hd, hd_v, err):
    """Refused as the forward's route refuses; head dims off the
    multiples of 8 take the route of their padded dims (60 and 121 pad to
    64 and 128: wgmma in bf16)."""
    from repro_torch.kernels.flash_attention.ops import flash_bwd_route
    with pytest.raises(err):
        flash_bwd_route(dtype, hd, hd_v)
    assert flash_bwd_route(torch.bfloat16, 60, 60) == "wgmma"
    assert flash_bwd_route(torch.bfloat16, 121, 121) == "wgmma"
    assert flash_bwd_route(torch.bfloat16, 121, 128) == "wgmma"
    assert flash_bwd_route(torch.bfloat16, 64, 128) == "mma_sync"
    assert flash_bwd_route(torch.float16, 60, 60) == "mma_sync"


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("hd", [64, 128])
def test_bwd_wgmma_smem_plan_fits_the_card(which, hd):
    """The shared memory a wgmma-route launch asks for (the owned
    operands, the ring, K11's lse and delta, 1024 B of alignment) fits
    the H100's 232,448 B a block with the static mbarriers beside it; the
    card tests hold the library's own figure to this one."""
    from repro_torch.kernels.conv2d_int8.ops import MAX_SMEM_BYTES
    from repro_torch.kernels.flash_attention.ops import (
        BWD_WGMMA_OWN, BWD_WGMMA_STAGES, BWD_WGMMA_TILE, bwd_wgmma_smem)
    smem = bwd_wgmma_smem(which, hd)
    assert smem + 8 * (1 + 2 * BWD_WGMMA_STAGES) <= MAX_SMEM_BYTES == 232448
    operand = 2 * hd                       # bytes of a bf16 row
    assert smem == (2 * BWD_WGMMA_OWN * operand + BWD_WGMMA_STAGES * (
        2 * BWD_WGMMA_TILE * operand + 1024 * which) + 1024)
    with pytest.raises(ValueError):
        bwd_wgmma_smem(which, 192)


# The wgmma route's operands, modelled in numpy: TMA writes a box of rows
# of 64 bf16 (128 B) with the 128-byte swizzle (the 16-byte chunk index
# XOR the row's index mod 8, over 1024-byte aligned blocks); a wgmma
# descriptor reads K-major rows i, 16 k at start + (i % 8) 128 + (i / 8)
# 1024 + 2k, or MN-major rows k, n at start + (k % 8) 128 + (k / 8) 1024 +
# (n % 64) 2 + (n / 64) LBO, the swizzle applied to each address.  K9's
# forward reads its Q, K and V through the same two forms.
SW_ROW, SW_BLOCK = 128, 1024
WG_OWN, WG_TILE = 128, 64


def _swizzle(addr):
    return addr ^ (((addr >> 7) & 7) << 4)


def _bf16_bits(x):
    """Round-to-nearest-even bf16 bits (uint16) of f32 values."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7fff + ((u >> 16) & 1)) >> 16
    return u.astype(np.uint16)


def _bf16_value(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _tma_operand(smem, base, x, box_rows):
    """x [rows, hd] (bf16 bits) as TMA lays it: hd / 64 panels of
    [box_rows][128 B]."""
    rows = np.arange(x.shape[0])[:, None]
    cols = np.arange(64)[None, :]
    for p in range(x.shape[1] // 64):
        addr = base + p * box_rows * SW_ROW + rows * SW_ROW + 2 * cols
        smem[_swizzle(addr) // 2] = x[:, 64 * p:64 * p + 64]


def _k_major(smem, start, rows):
    i, k = np.arange(rows)[:, None], np.arange(16)[None, :]
    addr = start + (i % 8) * SW_ROW + (i // 8) * SW_BLOCK + 2 * k
    return _bf16_value(smem[_swizzle(addr) // 2]).astype(np.float64)


def _mn_major(smem, start, n, lbo):
    k, j = np.arange(16)[:, None], np.arange(n)[None, :]
    addr = (start + (k % 8) * SW_ROW + (k // 8) * SW_BLOCK + (j % 64) * 2
            + (j // 64) * lbo)
    return _bf16_value(smem[_swizzle(addr) // 2]).astype(np.float64)


def _split_pair(x0, x1):
    """split_pair: the parts (lo, mid, hi) of two f32 values, each a
    packed pair of bf16 bits (x0 in the low half)."""
    parts = []
    r = np.array([x0, x1], np.float32)
    for _ in range(3):
        b = _bf16_bits(r)
        parts.append(int(b[0]) | int(b[1]) << 16)
        r = (r - _bf16_value(b)).astype(np.float32)
    assert not r.any()                     # three parts hold it exactly
    return parts[::-1]


def _accumulate_split(acc_tile, n_k, rhs):
    """A [64 x 16 n_k] f32 accumulator through the lanes: each warp's
    fragments (row g or g + 8, columns 8j + 2t, + 1), split in pairs into
    the A fragments of the next wgmma (a0: row g, k 2t; a1: row g + 8;
    a2, a3: k + 8), reassembled by that layout and multiplied by
    ``rhs(kk)``, the [16 x N] B of k-slice kk, part by part, smallest
    first.  Returns the sum and checks the parts add up to the tile."""
    n = rhs(0).shape[1]
    out = np.zeros((64, n))
    for kk in range(n_k):
        a_parts = np.zeros((3, 64, 16))
        for warp in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for r in range(4):
                    j = 2 * kk + (r >> 1)          # the accumulator n-tile
                    row = 16 * warp + g + 8 * (r & 1)
                    col = 8 * j + 2 * t
                    packed = _split_pair(acc_tile[row, col],
                                         acc_tile[row, col + 1])
                    # the A layout: register r of the lane
                    arow = 16 * warp + g + 8 * (r & 1)
                    ak = 2 * t + 8 * (r >> 1)
                    for part, word in enumerate(packed):
                        bits = np.array([word & 0xffff, word >> 16],
                                        np.uint16)
                        a_parts[part, arow, ak:ak + 2] = _bf16_value(bits)
        np.testing.assert_array_equal(
            a_parts.sum(0), acc_tile[:, 16 * kk:16 * kk + 16])
        for part in range(3):
            out += a_parts[part] @ rhs(kk)
    return out


def _operands(rng, *shapes):
    return [_bf16_bits(rng.standard_normal(s)) for s in shapes]


@pytest.mark.parametrize("wg", [0, 1])
@pytest.mark.parametrize("hd", [64, 128])
def test_dq_wgmma_fragments_compute_the_tile(hd, wg):
    """K10 on wgmma for one tile of warpgroup ``wg``, lane by lane: Q and
    dO owned (panels of 128 rows), K and V in ring stage 1 (panels of 64
    rows); S = Q K^T and dP = dO V^T through K-major descriptors at the
    kernel's offsets (wg * 64 rows, (kk % 4) 32 B within a row, kk / 4
    panels), then dQ += dS K with dS split in the lanes and K read
    MN-major (rows 16 kk, LBO a panel): equal to the products in f64."""
    rng = np.random.default_rng(hd + wg)
    panels = hd // 64
    own_bytes, tile_bytes = panels * WG_OWN * SW_ROW, panels * WG_TILE * SW_ROW
    qs, os_ = 0, own_bytes
    ks = 2 * own_bytes + 1 * 2 * tile_bytes          # stage 1
    vs = ks + tile_bytes
    smem = np.zeros((ks + 2 * tile_bytes) // 2, np.uint16)
    q, do, k, v = _operands(rng, (WG_OWN, hd), (WG_OWN, hd), (WG_TILE, hd),
                            (WG_TILE, hd))
    for base, x, rows in ((qs, q, WG_OWN), (os_, do, WG_OWN),
                          (ks, k, WG_TILE), (vs, v, WG_TILE)):
        _tma_operand(smem, base, x, rows)
    s = np.zeros((64, WG_TILE))
    dp = np.zeros((64, WG_TILE))
    for kk in range(hd // 16):
        off = (kk // 4) * WG_OWN * SW_ROW + wg * 64 * SW_ROW + (kk % 4) * 32
        toff = (kk // 4) * WG_TILE * SW_ROW + (kk % 4) * 32
        s += _k_major(smem, qs + off, 64) @ _k_major(smem, ks + toff, 64).T
        dp += _k_major(smem, os_ + off, 64) @ _k_major(smem, vs + toff,
                                                        64).T
    qf, dof, kf, vf = (_bf16_value(x).astype(np.float64)
                       for x in (q, do, k, v))
    rows = slice(64 * wg, 64 * wg + 64)
    np.testing.assert_allclose(s, qf[rows] @ kf.T, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dp, dof[rows] @ vf.T, rtol=1e-12, atol=1e-12)
    ds = (s * dp * 0.0721).astype(np.float32)        # any f32 values
    got = _accumulate_split(
        ds, WG_TILE // 16,
        lambda kk: _mn_major(smem, ks + 16 * kk * SW_ROW, hd,
                             WG_TILE * SW_ROW))
    np.testing.assert_allclose(got, ds.astype(np.float64) @ kf, rtol=1e-12,
                               atol=1e-9)


@pytest.mark.parametrize("wg", [0, 1])
@pytest.mark.parametrize("hd", [64, 128])
def test_dkv_wgmma_fragments_compute_the_tile(hd, wg):
    """K11 on wgmma for one query tile of warpgroup ``wg``, lane by lane:
    K and V owned, Q and dO in ring stage 1 (K11's stage holds lse and
    delta after them); S^T = K Q^T and dP^T = V dO^T through K-major
    descriptors, then dV += P^T dO and dK += dS^T Q with P^T and dS^T
    split in the lanes and dO and Q read MN-major from row 16 kk: equal to
    the products in f64; the stage's lse and delta slot starts on a
    1024-byte boundary after the two operands."""
    rng = np.random.default_rng(10 * hd + wg)
    panels = hd // 64
    own_bytes, tile_bytes = panels * WG_OWN * SW_ROW, panels * WG_TILE * SW_ROW
    stage = 2 * tile_bytes + 1024
    ks, vs = 0, own_bytes
    qs = 2 * own_bytes + 1 * stage                   # stage 1
    os_ = qs + tile_bytes
    assert (os_ + tile_bytes) % SW_BLOCK == 0        # lse and delta
    smem = np.zeros((qs + stage) // 2, np.uint16)
    k, v, q, do = _operands(rng, (WG_OWN, hd), (WG_OWN, hd), (WG_TILE, hd),
                            (WG_TILE, hd))
    for base, x, rows in ((ks, k, WG_OWN), (vs, v, WG_OWN),
                          (qs, q, WG_TILE), (os_, do, WG_TILE)):
        _tma_operand(smem, base, x, rows)
    kf, vf, qf, dof = (_bf16_value(x).astype(np.float64)
                       for x in (k, v, q, do))
    keys = slice(64 * wg, 64 * wg + 64)
    st, dpt = np.zeros((64, WG_TILE)), np.zeros((64, WG_TILE))
    for kk in range(hd // 16):
        off = (kk // 4) * WG_OWN * SW_ROW + wg * 64 * SW_ROW + (kk % 4) * 32
        toff = (kk // 4) * WG_TILE * SW_ROW + (kk % 4) * 32
        st += _k_major(smem, ks + off, 64) @ \
            _k_major(smem, qs + toff, WG_TILE).T
        dpt += _k_major(smem, vs + off, 64) @ \
            _k_major(smem, os_ + toff, WG_TILE).T
    np.testing.assert_allclose(st, kf[keys] @ qf.T, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dpt, vf[keys] @ dof.T, rtol=1e-12,
                               atol=1e-12)
    pt = np.exp(np.tanh(st * 0.01)).astype(np.float32)       # any f32
    dst = (dpt * pt * 0.0883).astype(np.float32)

    def rhs(xs):
        return lambda kk: _mn_major(smem, xs + 16 * kk * SW_ROW, hd,
                                    WG_TILE * SW_ROW)
    np.testing.assert_allclose(
        _accumulate_split(pt, WG_TILE // 16, rhs(os_)),
        pt.astype(np.float64) @ dof, rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(
        _accumulate_split(dst, WG_TILE // 16, rhs(qs)),
        dst.astype(np.float64) @ qf, rtol=1e-10, atol=1e-9)
