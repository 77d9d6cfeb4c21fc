"""Flash attention (K9-K11) on f16 operands and at head dims that are not
a multiple of 8, on the CPU: the port's plain versions against the JAX
package's Pallas kernels in interpret mode, reduced Phi-4-mini at
``dtype="float16"`` through both packages' forward, and the route and
padding rules of the wrapper (``kernels/flash_attention/ops.py``).

The card runs f16 on instances of its own (``flash_attention_f16``,
``flash_attention_bwd_f16``) and an odd head dim padded with zero columns
to the next multiple of 8; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold those against these plain versions.

Tolerances, as a share of max |reference| (o, dq, dk, dv) or absolute
(lse), set from this sandbox's readings with a margin of five or more:
f16's o within 1.8e-4 and its grads within 1.9e-4 of the JAX kernels'
(``REL``: 1e-3); bf16 and f32 as ``tests/test_torch_flash.py`` holds
them (2e-2 and 2e-5 for o, 1e-2 and 1e-5 for the grads); the lse within
1e-5 (it is computed in f32 in every dtype).  Reduced Phi-4-mini in f16:
the hidden states within 1e-2 x max|h| of the JAX package's, on the
blockwise route and on the kernel route (read: 1.2e-3 on both, as far as
the JAX package's own two routes lie apart).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.flash_attention.kernel import flash_attention_bwd \
    as jax_flash_bwd
from repro.kernels.flash_attention.kernel import flash_attention_kernel \
    as jax_flash_kernel
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tmod
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention.ops import (HEAD_DIM_MAX,
                                                     WGMMA_HEAD_DIMS,
                                                     flash_attention,
                                                     flash_attention_bwd,
                                                     flash_route,
                                                     kernel_widths,
                                                     launch_shape,
                                                     padded_dim)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.models import layers
from repro_torch.models import transformer as tmod

# the five ATTN_CASES of tests/test_kernels.py and one hd != hd_v case
# (as tests/test_torch_flash.py), then head dims 12 and 20
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
ODD_CASES = [
    dict(B=1, H=4, KV=2, S=128, hd=12, causal=True, window=0, softcap=0.0),
    dict(B=2, H=2, KV=2, S=64, hd=20, causal=True, window=16, softcap=30.0),
    dict(B=1, H=4, KV=1, S=128, hd=12, hd_v=20, causal=False, window=0,
         softcap=0.0),
    dict(B=1, H=2, KV=2, S=128, hd=20, hd_v=12, causal=True, window=0,
         softcap=0.0),
]
DTYPES = {"f16": (torch.float16, jnp.float16),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f32": (torch.float32, jnp.float32)}
# (o, grads) as a share of max |reference|
REL = {"f16": (1e-3, 1e-3), "bf16": (2e-2, 1e-2), "f32": (2e-5, 1e-5)}
LSE_TOL = 1e-5
LM_REL = 1e-2


def _kw(case):
    return dict(causal=case["causal"], window=case["window"],
                softcap=case["softcap"])


def _operands(case, seed):
    """q [B,H,S,hd], k [B,KV,S,hd], v [B,KV,S,hd_v], do [B,H,S,hd_v], f32
    numpy in the kernel layout."""
    rng = np.random.default_rng(seed)
    B, H, KV, S, hd = (case[x] for x in ("B", "H", "KV", "S", "hd"))
    hd_v = case.get("hd_v", hd)
    return tuple(rng.standard_normal(shape, np.float32) for shape in (
        (B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd_v), (B, H, S, hd_v)))


def _share(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


def _forward_and_backward(case, dtype, seed):
    """The port's plain forward and backward beside the JAX kernels', on
    the same operands in ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    q, k, v, do = _operands(case, seed)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jo, jlse = jax_flash_kernel(jq, jk, jv, return_lse=True, interpret=True,
                                **_kw(case))
    rep = case["H"] // case["KV"]
    want = jax_flash_bwd(jq, jnp.repeat(jk, rep, 1), jnp.repeat(jv, rep, 1),
                         jo, jlse, jdo, interpret=True, **_kw(case))
    tq, tk, tv, to, tdo = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                           for a in (jq, jk, jv, jo, jdo))
    o, lse = flash_attention_plain(tq, tk, tv, **_kw(case))
    grads = flash_attention_bwd_plain(tq, tk, tv, to,
                                      torch.from_numpy(np.array(jlse)),
                                      tdo, **_kw(case))
    return (o, lse, grads), (jo, jlse, want)


@pytest.mark.parametrize("ci", range(len(CASES)))
def test_f16_plain_matches_pallas(ci):
    (o, lse, grads), (jo, jlse, want) = _forward_and_backward(
        CASES[ci], "f16", 600 + ci)
    rel_o, rel_g = REL["f16"]
    assert o.dtype == torch.float16 and tuple(o.shape) == jo.shape
    assert _share(o, jo) <= rel_o
    assert np.abs(lse.numpy() - np.asarray(jlse)).max() <= LSE_TOL
    for g, w in zip(grads, want):
        assert g.dtype == torch.float16 and tuple(g.shape) == w.shape
        assert _share(g, w) <= rel_g


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ci", range(len(ODD_CASES)))
def test_odd_head_dims_plain_match_pallas(ci, dtype):
    """Head dims 12 and 20 (and each against the other for hd_v): the JAX
    kernel's block is the whole head dim, as the plain version's."""
    (o, lse, grads), (jo, jlse, want) = _forward_and_backward(
        ODD_CASES[ci], dtype, 700 + ci)
    rel_o, rel_g = REL[dtype]
    assert tuple(o.shape) == jo.shape
    assert _share(o, jo) <= rel_o
    assert np.abs(lse.numpy() - np.asarray(jlse)).max() <= LSE_TOL
    for g, w in zip(grads, want):
        assert tuple(g.shape) == w.shape
        assert _share(g, w) <= rel_g


@pytest.mark.parametrize("ci", range(len(ODD_CASES)))
def test_odd_head_dims_through_the_model_layout_wrapper(ci):
    """The wrapper on CPU tensors at an odd head dim: the plain version,
    no launch, the real head dim's shapes."""
    case = ODD_CASES[ci]
    q, k, v, _ = (torch.from_numpy(a).transpose(1, 2).contiguous()
                  for a in _operands(case, 800 + ci))
    reset_launches()
    o, lse = flash_attention(q, k, v, return_lse=True, **_kw(case))
    assert LAUNCHES == {}
    want, want_lse = flash_attention_plain(
        *(t.transpose(1, 2) for t in (q, k, v)), **_kw(case))
    assert torch.equal(o.transpose(1, 2), want) and torch.equal(lse,
                                                                 want_lse)


# -- the wrapper's rules ----------------------------------------------------


@pytest.mark.parametrize("d,padded", [(1, 8), (7, 8), (8, 8), (12, 16),
                                      (20, 24), (128, 128), (250, 256),
                                      (256, 256)])
def test_padded_dim(d, padded):
    assert padded_dim(d) == padded
    assert kernel_widths(padded, padded)[0] >= padded


@pytest.mark.parametrize("d", [0, 257, 264])
def test_padded_dim_refuses_outside_1_to_256(d):
    with pytest.raises(ValueError, match=f"head dim {d}"):
        padded_dim(d)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("hd,hd_v,route", [
    (64, 64, "wgmma"), (128, 128, "wgmma"), (60, 60, "wgmma"),
    (121, 121, "wgmma"), (12, 12, "mma_sync"), (120, 128, "mma_sync"),
    (192, 128, "mma_sync"), (20, 12, "mma_sync")])
def test_16_bit_routes_at_the_padded_dims(dtype, hd, hd_v, route):
    """A 16-bit pair takes wgmma where its padded dims are equal and in
    ``WGMMA_HEAD_DIMS``, f16 as bf16."""
    assert flash_route(dtype, hd, hd_v) == route
    assert (padded_dim(hd) == padded_dim(hd_v) and padded_dim(hd) in
            WGMMA_HEAD_DIMS) == (route == "wgmma")
    assert flash_route(torch.float32, hd, hd_v) == "f32"


def test_launch_shape_keys_the_real_head_dims_and_f16():
    key = launch_shape(torch.float16, 2, 4, 2, 128, 128, 12, 20, True, 0,
                       0.0)
    assert key == ("float16", 2, 4, 2, 128, 128, 12, 20, True, 0, 0.0)


def test_f16_f32_grads_are_the_sums():
    """f16 operands may ask for f32 grads (the sums before their rounding,
    a check path as bf16's); f32 operands may not."""
    case = CASES[2]
    q, k, v, do = (torch.from_numpy(a).half() for a in _operands(case, 900))
    o, lse = flash_attention_plain(q, k, v, **_kw(case))
    g16 = flash_attention_bwd(q, k, v, o, lse, do, **_kw(case))
    g32 = flash_attention_bwd(q, k, v, o, lse, do, out_dtype=torch.float32,
                              **_kw(case))
    for a, b in zip(g16, g32):
        assert a.dtype == torch.float16 and b.dtype == torch.float32
        assert torch.equal(a, b.half())
    with pytest.raises(TypeError, match="bf16 or f16 operands"):
        flash_attention_bwd(q.float(), k.float(), v.float(), o.float(), lse,
                            do.float(), out_dtype=torch.float16)
    assert HEAD_DIM_MAX == 256


# -- reduced Phi-4-mini in f16 through both packages -------------------------


@pytest.fixture(scope="module")
def phi_f16():
    jarch = dataclasses.replace(jax_get_arch("phi4-mini-3.8b").reduced(),
                                dtype="float16")
    arch = dataclasses.replace(get_arch("phi4-mini-3.8b").reduced(),
                               dtype="float16")
    jparams = jax_tmod.init_params(jax.random.PRNGKey(0), jarch)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jarch, jparams, arch, params


@pytest.mark.parametrize("route", ["blockwise", "kernel"])
def test_phi4_mini_f16_forward_matches(phi_f16, route):
    jarch, jparams, arch, params = phi_f16
    on = route == "kernel"
    jax_layers.set_kernel_mode(on, interpret=True)
    layers.set_kernel_mode(on)
    try:
        toks = np.random.default_rng(0).integers(0, 128, (2, 32)).astype(
            np.int32)
        want, _ = jax_tmod.forward(jparams, jarch,
                                   {"tokens": jnp.asarray(toks)})
        got, _ = tmod.forward(params, arch,
                              {"tokens": torch.from_numpy(toks)})
    finally:
        jax_layers.set_kernel_mode(False)
        layers.set_kernel_mode(True)
    assert got.dtype == torch.float16 and torch.isfinite(got).all()
    assert _share(got, want) <= LM_REL
