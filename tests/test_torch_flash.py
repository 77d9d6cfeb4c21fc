"""The port's plain flash-attention forward (K9) against the JAX package's
Pallas kernel in interpret mode, and against the port's own oracle.

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

from repro.kernels.flash_attention.kernel import flash_attention_kernel \
    as jax_flash_kernel
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_kernel)
from repro_torch.kernels.flash_attention.ref import (flash_attention_plain,
                                                     flash_attention_ref)

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
