"""Each hand kernel's charge (``charge*`` beside its wrapper in
``kernels/*/ops.py``) against the
reference's count of the ``pl.pallas_call`` it replaces, on the CPU: the
JAX call is traced with ``jax.make_jaxpr`` (interpret mode) and counted by
``repro.roofline.jaxpr_cost``'s ``pallas_call`` rule (operands plus
results; the body's FLOPs times the grid).  For K1–K11 at two small shapes
and more: bytes exact, the body's dot FLOPs exact, total FLOPs within 1%
(they come out exact).  K10 and K11 read k and v at their KV heads where
the JAX wrapper hands its kernels k and v repeated to H heads: with GQA
their bytes differ by exactly the repeat.

Also the charge's plumbing: a launch charges the active counter, a
capture records its launches' charge and each replay charges it, and the
flash wrappers on ``meta`` tensors charge without launching."""
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.conv2d_int8.ops import conv2d_int8 as jax_conv
from repro.kernels.flash_attention.kernel import (
    flash_attention_bwd as jax_flash_bwd,
    flash_attention_kernel as jax_flash)
from repro.kernels.pool_int8.ops import (global_avgpool_int8 as jax_gap,
                                         maxpool_int8 as jax_maxpool)
from repro.kernels.stream_matmul.ops import stream_matmul as jax_mm
from repro.roofline import jaxpr_cost as jc
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_int8 import ops as conv_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_vjp)
from repro_torch.kernels.pool_int8 import ops as pool_ops
from repro_torch.kernels.stream_matmul import ops as mm_ops
from repro_torch.roofline.op_cost import count, counting

S = jax.ShapeDtypeStruct


def _body(eqn):
    b = eqn.params["jaxpr"]
    return b.jaxpr if hasattr(b, "jaxpr") else b


def _dots(jaxpr, mult=1):
    """The dot FLOPs of a kernel body, a scan's body times its length."""
    t = 0
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            t += jc._dot_flops(e) * mult
        elif e.primitive.name == "scan":
            t += _dots(_body(e), mult * e.params["length"])
        else:
            for s in jc._sub_jaxprs(e.params):
                t += _dots(s, mult)
    return t


def jax_calls(fn, *args):
    """(flops, bytes, dot FLOPs) of every ``pallas_call`` ``fn`` makes."""
    out = []

    def walk(jaxpr):
        for e in jaxpr.eqns:
            if e.primitive.name == "pallas_call":
                grid = math.prod(e.params["grid_mapping"].grid)
                c = jc._eqn_cost(e)
                out.append((c.flops, c.bytes, _dots(_body(e)) * grid))
            else:
                for s in jc._sub_jaxprs(e.params):
                    walk(s)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


def check(charge, want, extra_bytes=0):
    flops, nbytes, dots = want
    assert charge.bytes == nbytes - extra_bytes
    assert charge.matmul_flops == dots
    assert abs(charge.flops - flops) <= 0.01 * flops
    assert charge.flops == flops          # and in fact exactly


CONV_SHAPES = [(8, 8, 4, 8, 3, 1), (9, 7, 8, 4, 3, 2), (6, 10, 4, 12, 1, 1),
               (5, 5, 4, 8, 5, 2)]


@pytest.mark.parametrize("depthwise", [False, True])
@pytest.mark.parametrize("stream,nb", [(False, 2), (True, 1), (True, 3)])
@pytest.mark.parametrize("H,W,C,C_out,k,s", CONV_SHAPES)
def test_conv_k1_to_k4(H, W, C, C_out, k, s, stream, nb, depthwise):
    co = C if depthwise else C_out
    x = S((2, H, W, C), jnp.int8)
    w = S((k, k, 1, C) if depthwise else (k, k, C, C_out), jnp.int8)
    want, = jax_calls(lambda x, w: jax_conv(
        x, w, stride=s, stream=stream, n_buffers=nb, depthwise=depthwise,
        interpret=True), x, w)
    check(conv_ops.charge(2, H, W, C, co, k, k, s, depthwise=depthwise),
          want)


@pytest.mark.parametrize("H,W,C,k,s", [(8, 8, 4, 3, 2), (9, 7, 8, 3, 2),
                                       (6, 10, 4, 2, 2), (11, 13, 20, 3, 1)])
def test_maxpool_k5(H, W, C, k, s):
    want, = jax_calls(lambda x: jax_maxpool(x, k=k, stride=s,
                                            interpret=True),
                      S((2, H, W, C), jnp.int8))
    check(pool_ops.charge_maxpool(2, H, W, C, k, s), want)


@pytest.mark.parametrize("H,W,C", [(7, 7, 8), (4, 5, 12), (3, 3, 20)])
def test_global_avgpool_k6(H, W, C):
    want, = jax_calls(lambda x: jax_gap(x, interpret=True),
                      S((2, H, W, C), jnp.int8))
    check(pool_ops.charge_global_avgpool(2, H, W, C), want)


@pytest.mark.parametrize("mode", ["pinned", "stream", "fifo"])
@pytest.mark.parametrize("dtype,out_bytes", [(jnp.int8, 4),
                                             (jnp.float32, 4),
                                             (jnp.bfloat16, 2)])
@pytest.mark.parametrize("M,K,N,bk,nb", [(8, 1024, 256, 512, 2),
                                         (16, 512, 128, 256, 3),
                                         (256, 768, 256, 256, 1)])
def test_matmul_k7_k8(M, K, N, bk, nb, dtype, out_bytes, mode):
    """K7 (pinned, stream) and K8 (fifo: the JAX body's K loop is a
    ``fori_loop`` that lowers to a scan, counted every trip)."""
    want, = jax_calls(lambda x, w: jax_mm(x, w, mode=mode, bk=bk,
                                          n_buffers=nb, interpret=True),
                      S((M, K), dtype), S((K, N), dtype))
    eb = jnp.dtype(dtype).itemsize
    check(mm_ops.charge(M, K, N, eb, eb, out_bytes, mode=mode, bk=bk,
                    n_buffers=nb), want)


FLASH_SHAPES = [(1, 2, 2, 256, 256, 64, 64), (2, 2, 2, 128, 384, 32, 64),
                (1, 4, 4, 64, 64, 128, 128)]
MASKS = [(True, 0, 0.0), (False, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0),
         (True, 32, 20.0)]


@pytest.mark.parametrize("causal,window,softcap", MASKS)
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,hd_v", FLASH_SHAPES)
def test_flash_k9_k10_k11(B, H, KV, Sq, Sk, hd, hd_v, dtype, causal, window,
                          softcap):
    q, k, v = (S((B, H, Sq, hd), dtype), S((B, KV, Sk, hd), dtype),
               S((B, KV, Sk, hd_v), dtype))
    mask = dict(causal=causal, window=window, softcap=softcap)
    want, = jax_calls(lambda q, k, v: jax_flash(
        q, k, v, interpret=True, return_lse=True, **mask), q, k, v)
    eb = jnp.dtype(dtype).itemsize
    check(flash_ops.charge_fwd(B, H, KV, Sq, Sk, hd, hd_v, eb, **mask),
          want)
    o, lse = S((B, H, Sq, hd_v), dtype), S((B, H, Sq), jnp.float32)
    dq, dkv = jax_calls(lambda q, k, v, o, lse, do: jax_flash_bwd(
        q, k, v, o, lse, do, interpret=True, **mask), q, k, v, o, lse, o)
    check(flash_ops.charge_bwd_dq(B, H, KV, Sq, Sk, hd, hd_v, eb, eb,
                                  **mask), dq)
    check(flash_ops.charge_bwd_dkv(B, H, KV, Sq, Sk, hd, hd_v, eb, eb,
                                   **mask), dkv)


def test_flash_bwd_gqa_reads_kv_heads():
    """H 4, KV 2: the JAX kernels read k and v repeated to H heads."""
    B, H, KV, Sq, Sk, hd, hd_v, eb = 1, 4, 2, 128, 128, 64, 64, 2
    q, o = S((B, H, Sq, hd), jnp.bfloat16), S((B, H, Sq, hd_v), jnp.bfloat16)
    kr, vr = S((B, H, Sk, hd), jnp.bfloat16), S((B, H, Sk, hd_v),
                                                jnp.bfloat16)
    lse = S((B, H, Sq), jnp.float32)
    dq, dkv = jax_calls(lambda q, k, v, o, lse, do: jax_flash_bwd(
        q, k, v, o, lse, do, causal=True, window=0, softcap=0.0,
        interpret=True), q, kr, vr, o, lse, o)
    repeat = eb * B * (H - KV) * Sk * (hd + hd_v)
    mask = dict(causal=True, window=0, softcap=0.0)
    check(flash_ops.charge_bwd_dq(B, H, KV, Sq, Sk, hd, hd_v, eb, eb,
                                  **mask), dq, extra_bytes=repeat)
    check(flash_ops.charge_bwd_dkv(B, H, KV, Sq, Sk, hd, hd_v, eb, eb,
                                   **mask), dkv, extra_bytes=repeat)


def test_k9_charge_at_a_figure_of_the_reference():
    """K9 at (B 1, S 256, H 2, hd 64), causal, bf16: the count
    ``repro.roofline.jaxpr_cost.cost_of`` gives the JAX call (every
    tile, masked or not, and the body's elementwise work: more than the
    dense 4·B·H·S²·hd)."""
    c = flash_ops.charge_fwd(1, 2, 2, 256, 256, 64, 64, 2, causal=True,
                             window=0, softcap=0.0)
    assert (c.flops, c.bytes) == (36_398_160, 264_192)


def test_a_launch_charges_the_counter_and_a_replay_its_capture():
    charge = (10, 20, 4)
    with counting() as c:
        _build.count_launch("probe_kernel", cost=charge)
    assert (c.cost.flops, c.cost.bytes, c.cost.matmul_flops) == (10, 20, 4)
    with _build.capturing_launches() as graph:
        _build.count_launch("probe_kernel", cost=charge)
        _build.count_launch("probe_kernel", cost=charge)
    assert graph.counts == {"probe_kernel": 2}
    assert graph.charge == (20, 40, 8)
    with counting() as c:
        _build.count_replay(graph)
        _build.count_replay(graph)
    assert (c.cost.flops, c.cost.bytes) == (40, 80)
    _build.LAUNCHES.pop("probe_kernel", None)


def test_flash_on_meta_charges_without_launching():
    """The forward on ``meta`` charges K9; the backward K10 and K11; no
    launch is counted and no kernel is built."""
    B, S_, H, KV, hd = 1, 256, 4, 2, 64
    q = torch.empty(B, S_, H, hd, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, S_, KV, hd, dtype=torch.bfloat16, device="meta")
    _build.reset_launches()
    fwd = flash_ops.charge_fwd(B, H, KV, S_, S_, hd, hd, 2, causal=True,
                               window=0, softcap=0.0)
    c = count(lambda: flash_attention(q, k, k, causal=True))
    assert c.matmul_flops == fwd.matmul_flops
    assert c.bytes == fwd.bytes
    qg, kg = q.requires_grad_(), k.requires_grad_()

    def step():
        o = flash_attention_vjp.apply(qg, kg, kg, True, 0, 0.0)
        torch.autograd.grad(o.float().sum(), (qg, kg))
    c = count(step)
    mask = dict(causal=True, window=0, softcap=0.0)
    dq = flash_ops.charge_bwd_dq(B, H, KV, S_, S_, hd, hd, 2, 2, **mask)
    dkv = flash_ops.charge_bwd_dkv(B, H, KV, S_, S_, hd, hd, 2, 2, **mask)
    assert c.matmul_flops == fwd.matmul_flops + dq.matmul_flops + \
        dkv.matmul_flops
    assert c.flops > fwd.flops + dq.flops + dkv.flops
    assert not _build.LAUNCHES
