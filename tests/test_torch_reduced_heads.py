"""Head dims below 32 and between the widths the flash kernels are built
at, and the float matmul's other operand pairs, on the CPU.

The JAX package's reduced LM configs (``ArchConfig.reduced()``) attend
at head dim 16, DeepSeek-V2's reduced MLA at qk 24 / v 16; its Pallas
kernels take any head dim.  The port's kernels take every multiple of 8
from 8 to 256 (``flash_route``, ``kernel_widths``).  Here the port's
plain flash attention, forward through ``flash_attention_vjp`` and its
backward, is held against the JAX package's ``flash_attention_vjp`` in
interpret mode at those shapes, within ``tests/test_torch_flash.py``'s
tolerances; every head-dim pair gets its route; and the streamed matmul
at every operand pair ``jnp.promote_types`` resolves over {int8, f16,
bf16, f32} but int8 x int8 is held to the JAX kernels in interpret mode,
its result of the promoted type, with its launch plan for 1-, 2- and
4-byte elements.  The CUDA kernels are held against these plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Inputs are made with numpy from a seed and handed to both frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import \
    flash_attention_vjp as jax_flash_vjp
from repro.kernels.stream_matmul.ops import stream_matmul as jax_matmul
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.conv2d_int8.ops import MAX_SMEM_BYTES
from repro_torch.kernels.flash_attention.ops import (HEAD_DIM_MAX,
                                                     HEAD_DIM_STEP, KERNEL_HD,
                                                     KERNEL_HD_V,
                                                     WGMMA_HEAD_DIMS,
                                                     flash_attention_vjp,
                                                     flash_route, head_dim_ok,
                                                     kernel_widths)
from repro_torch.kernels.stream_matmul.ops import (FLOAT_DTYPES,
                                                   FLOAT_TYPE_CODES,
                                                   MM_FLOAT_KBLK,
                                                   MM_FLOAT_KBLK_I8,
                                                   MM_FLOAT_TC_UNIT,
                                                   mm_float_kstep,
                                                   mm_float_layout,
                                                   mm_float_plan, ring,
                                                   stream_matmul)
from repro_torch.kernels.stream_matmul.ref import (result_dtype,
                                                   stream_matmul_ref)
from test_torch_flash import BWD_REL, DTYPES, _close

# the shapes the reduced configs give the flash kernels (B, S, H, KV, hd,
# hd_v, causal): a decoder's prefill of 8 tokens (GQA), SeamlessM4T's
# encoder over 16 frames (non-causal), DeepSeek-V2's MLA (qk 24 / v 16),
# and the training launcher's 64 tokens at both head-dim pairs
REDUCED = [
    dict(B=2, S=8, H=4, KV=2, hd=16, hd_v=16, causal=True),
    dict(B=2, S=16, H=4, KV=4, hd=16, hd_v=16, causal=False),
    dict(B=2, S=8, H=4, KV=4, hd=24, hd_v=16, causal=True),
    dict(B=2, S=64, H=4, KV=2, hd=16, hd_v=16, causal=True),
    dict(B=2, S=64, H=4, KV=4, hd=24, hd_v=16, causal=True),
]
REDUCED_IDS = ["S{S}-H{H}-KV{KV}-hd{hd}-hdv{hd_v}-{c}".format(
    c="causal" if c["causal"] else "full", **c) for c in REDUCED]


def _case_inputs(case, seed):
    """q [B,S,H,hd], k [B,S,KV,hd], v [B,S,KV,hd_v] and the gradient of
    the output [B,S,H,hd_v], f32 numpy."""
    rng = np.random.default_rng(seed)
    B, S, H, KV = (case[x] for x in ("B", "S", "H", "KV"))
    return (rng.standard_normal((B, S, H, case["hd"]), np.float32),
            rng.standard_normal((B, S, KV, case["hd"]), np.float32),
            rng.standard_normal((B, S, KV, case["hd_v"]), np.float32),
            rng.standard_normal((B, S, H, case["hd_v"]), np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ci", range(len(REDUCED)), ids=REDUCED_IDS)
def test_vjp_matches_pallas_at_reduced_head_dims(ci, dtype):
    """The port's differentiable flash attention (plain forward and
    backward on CPU tensors, the GQA fold) against the JAX package's
    ``flash_attention_vjp`` (its Pallas forward and backward kernels in
    interpret mode): the output within the forward's tolerance, dq, dk
    and dv within ``BWD_REL`` of their largest value."""
    case = REDUCED[ci]
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v, g = _case_inputs(case, 500 + ci)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    want, pull = jax.vjp(
        lambda a, b, c: jax_flash_vjp(a, b, c, case["causal"], 0, 0.0, 128,
                                      128, True), jq, jk, jv)
    want_grads = pull(jg)
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                  .requires_grad_(True) for a in (jq, jk, jv))
    reset_launches()
    got = flash_attention_vjp.apply(tq, tk, tv, case["causal"], 0, 0.0)
    grads = torch.autograd.grad(
        got, (tq, tk, tv), torch.from_numpy(np.array(jg, np.float32)).to(tdt))
    assert LAUNCHES == {}                  # CPU tensors launch nothing
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    _close(got.detach(), want, tol)
    for name, gt, w in zip(("dq", "dk", "dv"), grads, want_grads):
        w = np.asarray(w, np.float32)
        assert gt.dtype == tdt and tuple(gt.shape) == w.shape, name
        err = np.abs(gt.float().numpy() - w).max()
        assert err <= BWD_REL[dtype] * np.abs(w).max(), (name, err)


def test_reduced_cases_are_the_reduced_configs_shapes():
    """The first three cases are what ``launch/serve.py --reduced`` gives
    the kernel (8-token prompts at 2 slots; SeamlessM4T's 16 frames), the
    last two what ``launch/train.py --reduced`` gives it (64 tokens)."""
    from repro_torch.configs import get_arch
    phi = get_arch("phi4-mini-3.8b").reduced()
    dsv2 = get_arch("deepseek-v2-236b").reduced()
    seam = get_arch("seamless-m4t-medium").reduced()
    assert (phi.n_heads, phi.n_kv_heads, phi.head_dim) == (4, 2, 16)
    assert (dsv2.mla.qk_nope_head_dim + dsv2.mla.qk_rope_head_dim,
            dsv2.mla.v_head_dim) == (24, 16)
    assert (seam.n_heads, seam.n_kv_heads, seam.n_frames) == (4, 4, 16)
    for case in REDUCED:
        assert flash_route(torch.bfloat16, case["hd"], case["hd_v"]) == \
            "mma_sync"
        assert kernel_widths(case["hd"], case["hd_v"]) == (32, 32)


# ---------------------------------------------------------------------------
# the routes
# ---------------------------------------------------------------------------

# (hd, hd_v, the bf16 route, the widths the bf16 kernels run it at): the
# reduced configs' pairs, the pairs that ran before (on the same routes),
# and others between and at the ends of the range
ROUTES = [
    (16, 16, "mma_sync", (32, 32)), (24, 16, "mma_sync", (32, 32)),
    (8, 8, "mma_sync", (32, 32)), (16, 24, "mma_sync", (32, 32)),
    (32, 32, "mma_sync", (32, 32)), (40, 40, "mma_sync", (64, 64)),
    (48, 48, "mma_sync", (64, 64)), (64, 64, "wgmma", (64, 64)),
    (64, 128, "mma_sync", (64, 128)), (96, 96, "mma_sync", (128, 128)),
    (128, 128, "wgmma", (128, 128)), (192, 128, "mma_sync", (192, 128)),
    (136, 192, "mma_sync", (192, 256)), (200, 8, "mma_sync", (256, 32)),
    (256, 256, "mma_sync", (256, 256)), (8, 256, "mma_sync", (32, 256)),
]


@pytest.mark.parametrize("hd,hd_v,route,widths", ROUTES)
def test_route_and_widths_of_a_head_dim_pair(hd, hd_v, route, widths):
    assert flash_route(torch.bfloat16, hd, hd_v) == route
    assert flash_route(torch.float32, hd, hd_v) == "f32"
    assert kernel_widths(hd, hd_v) == widths


def test_every_multiple_of_8_has_a_route_and_the_narrowest_widths():
    dims = range(HEAD_DIM_STEP, HEAD_DIM_MAX + 1, HEAD_DIM_STEP)
    assert len(dims) == 32
    for hd in dims:
        for hd_v in dims:
            HD, HDV = kernel_widths(hd, hd_v)
            assert HD == min(w for w in KERNEL_HD if w >= hd)
            assert HDV == min(w for w in KERNEL_HD_V if w >= hd_v)
            want = "wgmma" if hd == hd_v and hd in WGMMA_HEAD_DIMS \
                else "mma_sync"
            assert flash_route(torch.bfloat16, hd, hd_v) == want
    assert [d for d in range(0, 300) if head_dim_ok(d)] == list(dims)


@pytest.mark.parametrize("hd,hd_v", [(12, 16), (16, 12), (264, 16),
                                     (16, 264), (0, 16), (4, 4), (260, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_refuses_a_head_dim_off_the_rule(dtype, hd, hd_v):
    with pytest.raises(ValueError, match=f"hd={hd}, hd_v={hd_v}"):
        flash_route(dtype, hd, hd_v)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernel_widths(hd, hd_v)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_route_refuses_f16_and_f64(dtype):
    with pytest.raises(TypeError, match="bf16 or f32"):
        flash_route(dtype, 16, 16)


# ---------------------------------------------------------------------------
# the float matmul's other operand pairs
# ---------------------------------------------------------------------------

TYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                       torch.bfloat16),
         "f16": (jnp.float16, torch.float16), "int8": (jnp.int8, torch.int8)}
#: the pairs the card took before: f32 and bf16 in any pair, int8 x int8
OLD_PAIRS = {("f32", "f32"), ("f32", "bf16"), ("bf16", "f32"),
             ("bf16", "bf16"), ("int8", "int8")}
NEW_PAIRS = sorted((a, b) for a in TYPES for b in TYPES
                   if (a, b) not in OLD_PAIRS)
BYTES = {"f32": 4, "bf16": 2, "f16": 2, "int8": 1}
RINGS = [("pinned", 2), ("stream", 2), ("fifo", 1), ("fifo", 3)]


def test_new_pairs_are_every_pair_with_f16_or_int8():
    assert len(NEW_PAIRS) == 11
    assert set(FLOAT_DTYPES) == {t for _, t in TYPES.values()}
    assert sorted(FLOAT_TYPE_CODES.values()) == [0, 1, 2, 3]


def _mm_operands(rng, shape, xd, wd):
    """x, w from numpy in their types (int8 as integers in [-127, 127]),
    for both packages."""
    M, K, N = shape

    def draw(shape, name):
        if name == "int8":
            a = rng.integers(-127, 128, size=shape).astype(np.int8)
        else:
            a = rng.normal(size=shape).astype(np.float32)
        return jnp.asarray(a, TYPES[name][0])
    x, w = draw((M, K), xd), draw((K, N), wd)

    def to_torch(a, name):
        t = torch.from_numpy(np.array(a, np.int8 if name == "int8"
                                      else np.float32))
        return t.to(TYPES[name][1])
    return x, w, to_torch(x, xd), to_torch(w, wd)


def _out_tol(out_dtype):
    """tests/test_kernels.py's limits by the output's type: 2e-5 for f32,
    2e-2 for bf16 and for f16 (the bf16 bound), as rtol and as a share of
    max |ref| for atol."""
    return 2e-5 if out_dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("mode,nb", RINGS)
@pytest.mark.parametrize("xd,wd", NEW_PAIRS)
def test_new_pair_matches_pallas(xd, wd, mode, nb):
    rng = np.random.default_rng(BYTES[xd] * 10 + BYTES[wd] + nb)
    x, w, tx, tw = _mm_operands(rng, (8, 64, 32), xd, wd)
    want = jax_matmul(x, w, mode=mode, bm=8, bk=16, bn=16, n_buffers=nb,
                      interpret=True)
    reset_launches()
    got = stream_matmul(tx, tw, mode=mode, bk=16, n_buffers=nb)
    assert LAUNCHES == {}
    promoted = jnp.promote_types(TYPES[xd][0], TYPES[wd][0])
    assert want.dtype == promoted
    assert str(got.dtype).split(".")[1] == jnp.dtype(promoted).name
    assert got.dtype == result_dtype(tx.dtype, tw.dtype)
    want32 = np.asarray(want, np.float32)
    tol = _out_tol(got.dtype)
    np.testing.assert_allclose(got.float().numpy(), want32, rtol=tol,
                               atol=tol * float(np.abs(want32).max()))


# plan shapes: the JAX tests' shapes, a ragged one (odd K and N, so
# one-element copies of 1- and 2-byte rows), an fc head and VGG-16's fc0
PLAN_SHAPES = [(128, 256, 128), (17, 100, 36), (5, 33, 7), (8, 2048, 1000),
               (8, 25088, 4096)]


@pytest.mark.parametrize("xd,wd", NEW_PAIRS)
@pytest.mark.parametrize("mode", ["pinned", "stream", "fifo"])
def test_plan_takes_1_2_and_4_byte_elements(xd, wd, mode):
    xb, wb = BYTES[xd], BYTES[wd]
    for M, K, N in PLAN_SHAPES:
        if mode == "pinned" and K > 8192:
            continue
        for nb, bk in ((1, 16), (2, 128), (3, 512)):
            plan = mm_float_plan(M, K, N, mode, bk, nb, xb, wb)
            step = mm_float_kstep(xb, wb)
            assert plan.tensor_cores == (wb <= 2)
            assert step == (MM_FLOAT_TC_UNIT if plan.tensor_cores else
                            MM_FLOAT_KBLK_I8 if xb == 1 else MM_FLOAT_KBLK)
            if mode == "pinned":
                assert (plan.kblk, plan.nb) == (plan.kr, 1)
            else:
                blk, depth = ring(mode, K, bk, nb)
                assert plan.kblk % step == 0
                assert plan.kblk <= max(step, blk)
                assert plan.nb == min(depth, -(-plan.kr // plan.kblk))
            assert plan.split * plan.kr >= K > (plan.split - 1) * plan.kr
            for vec, row, es in ((plan.wvec, N * wb, wb),
                                 (plan.xvec, K * xb, xb)):
                assert vec == next(v for v in (16, 8, 4, es) if row % v == 0)
            if plan.xvec == 16:     # 16-byte x copies: 16-byte slot rows
                assert (plan.kblk * xb) % 16 == 0
            assert plan.smem_bytes == mm_float_layout(
                plan.tn, plan.kblk, plan.nb, xb, wb, plan.tma) \
                <= MAX_SMEM_BYTES


def test_f32_and_bf16_plans_are_unchanged():
    """The pairs with f32 weights keep their FFMA plans (K blocks a
    multiple of 8 rows, of 16 where x is int8); bf16 x bf16 and every
    other pair with bf16, f16 or int8 weights, an f32 x's among them,
    take the tensor-core plan, K blocks and ranges a multiple of 32
    rows."""
    for xb, wb in ((4, 4), (2, 4)):
        assert mm_float_plan(17, 100, 36, "stream", 8, 2, xb, wb).kblk == 8
        assert mm_float_plan(8, 4096, 1000, "fifo", 24, 3, xb, wb).kblk == 24
    assert mm_float_plan(8, 4096, 1000, "fifo", 24, 3, 1, 4).kblk == 16
    for xb, wb in ((2, 2), (1, 2), (2, 1), (4, 2), (4, 1)):
        for shape, bk, kblk in (((17, 100, 36), 8, 32),
                                ((8, 4096, 1000), 24, 32),
                                ((8, 4096, 1000), 100, 96)):
            plan = mm_float_plan(*shape, "fifo", bk, 3, xb, wb)
            assert plan.tensor_cores and plan.kblk == kblk
            assert plan.kr % MM_FLOAT_TC_UNIT == 0


def test_cpu_plain_version_widens_int8_exactly():
    """An int8 operand against a float one: every int8 value is exact in
    bf16 and f16, so the plain version equals the f64 product rounded
    once."""
    x = torch.arange(-128, 128, dtype=torch.int8).reshape(16, 16)
    w = torch.eye(16, dtype=torch.float16) * 0.5
    got = stream_matmul(x, w, mode="fifo", bk=16, n_buffers=2)
    assert got.dtype == torch.float16
    assert torch.equal(got, (x.double() * 0.5).half())
    got = stream_matmul(w.bfloat16(), x, mode="pinned")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (x.double() * 0.5).bfloat16())
