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
    q = torch.zeros((1, 2, 64, 32))
    lse = torch.zeros((1, 2, 64))
    with pytest.raises(TypeError, match="bf16 operands"):
        flash_attention_bwd(q, q, q, q, lse, q, out_dtype=torch.bfloat16)


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
    (torch.float16, 128, 128, TypeError), (torch.bfloat16, 12, 12, ValueError),
    (torch.bfloat16, 128, 264, ValueError), (torch.float32, 12, 64,
                                             ValueError)])
def test_flash_route_refuses_what_no_kernel_takes(dtype, hd, hd_v, err):
    with pytest.raises(err):
        flash_route(dtype, hd, hd_v)


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
