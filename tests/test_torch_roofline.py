"""The port's cost counter and roofline (``roofline/op_cost.py``,
``roofline/analysis.py``) on the CPU: the reference's tests of
``tests/test_roofline.py`` that parse no HLO, ported (dot FLOPs exact, a
loop of 10 matmuls counted 10 times, the backward counted, conv FLOPs
exact, pure elementwise moving 0 bytes, the terms and dominance over the
H100's constants), and the counts of the two packages held together on
reduced Phi-4-mini, Qwen2-MoE and xLSTM: forward, prefill, a decode step
and a train step, all on abstract inputs (``meta`` tensors for the port,
``ShapeDtypeStruct``s for the JAX package), kernel mode off in both.

What is held, and why not more:

* matmul and conv FLOPs: exactly equal in the forward, the prefill and
  the decode step of the dense and the MoE family; elsewhere equal up to
  ``matmul_gap``, an exact formula of the arch's widths for each thing
  that runs otherwise in the two packages (not a difference of the
  counting): rematerialisation (the JAX package checkpoints each
  attention kv step once more inside the layer; torch's checkpoint reruns
  a layer up to the last tensor its backward needs, so it reruns the MoE
  combine, which JAX's drops), products that ``torch.einsum`` evaluates
  as an elementwise multiply where ``jnp.einsum`` makes a
  ``dot_general`` (a pair with no contracted dim, or one of size 1), and
  gradients that autograd does not compute (of a recurrence's zero
  initial state; of its final state, which the loss does not read) where
  JAX's scan transposes every product of its body.
* total FLOPs, ``bytes`` and ``bytes_unfused``: the elementwise work is
  decomposed otherwise in a jaxpr and in aten (a view counts its
  elements, and ``torch.einsum`` makes many views; an ``einsum`` may
  copy its operands into a matmul layout; the port's decode step copies
  the KV heads out to the query heads; a scan's backward transposes its
  body's operands), so each ratio port / JAX is held within 1% of its
  reading on this CPU (``READINGS``, one per arch and step): a change
  of either counter shows.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as jax_tmod
from repro.optim import adamw as jax_adamw
from repro.roofline import jaxpr_cost as jc
from repro.runtime.trainer import TrainConfig as JaxTrainConfig
from repro.runtime.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch
from repro_torch.models import layers
from repro_torch.models import transformer as tmod
from repro_torch.optim import adamw
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import NOT_COUNTED, Roofline, analyze
from repro_torch.roofline.op_cost import cost_of, count
from repro_torch.runtime.trainer import TrainConfig, make_train_step


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# -- the reference's tests ---------------------------------------------------


def test_dot_flops_exact():
    c = cost_of(lambda a, b: a @ b, meta(64, 128), meta(128, 32))
    assert c["flops"] == 2 * 64 * 128 * 32
    assert c["bytes"] == 4 * (64 * 128 + 128 * 32 + 64 * 32)


def test_loop_counts_every_trip():
    """The reference's scan of 10 matmuls; the port's loop runs 10 times."""
    def f(x, ws):
        for w in ws:
            x = x @ w
        return x
    c = cost_of(f, meta(64, 64), meta(10, 64, 64))
    assert c["matmul_flops"] == 10 * 2 * 64**3
    assert 10 * 2 * 64**3 <= c["flops"] < 11 * 2 * 64**3


def test_grad_counts_backward():
    def f(a, b):
        return (a @ b).sum()

    def g(a, b):
        a, b = a.requires_grad_(), b.requires_grad_()
        return torch.autograd.grad(f(a, b), (a, b))
    fwd = cost_of(f, meta(64, 64), meta(64, 64))["flops"]
    both = cost_of(g, meta(64, 64), meta(64, 64))
    assert both["flops"] - fwd >= 2 * fwd * 0.9            # dA and dB
    assert both["matmul_flops"] == 3 * 2 * 64**3


def test_conv_flops():
    c = cost_of(lambda x, w: F.conv2d(x, w, padding=1), meta(1, 4, 8, 8),
                meta(16, 4, 3, 3))
    assert c["flops"] == 2 * (8 * 8 * 16) * (3 * 3 * 4)
    grouped = cost_of(lambda x, w: F.conv2d(x, w, padding=1, groups=4),
                      meta(1, 4, 8, 8), meta(4, 1, 3, 3))
    assert grouped["matmul_flops"] == 2 * (8 * 8 * 4) * (3 * 3)


def test_fused_traffic_excludes_elementwise():
    c = cost_of(lambda a: torch.tanh(a) + 1.0, meta(1024, 1024))
    assert c["bytes"] == 0
    assert c["flops"] == 2 * 1024 * 1024
    assert c["bytes_unfused"] == 4 * 4 * 1024 * 1024


def test_traffic_rules():
    """Reductions move operands and results; a gather twice its result; a
    layout copy twice its result; a write into a slice twice its update."""
    x = meta(64, 32)
    assert cost_of(lambda x: x.sum(-1), x)["bytes"] == 4 * (64 * 32 + 64)
    idx = torch.empty(8, dtype=torch.int64, device="meta")
    assert cost_of(lambda x, i: x[i], x, idx)["bytes"] == 2 * 4 * 8 * 32
    assert cost_of(lambda x: x.t().contiguous(), x)["bytes"] == \
        2 * 4 * 64 * 32
    assert cost_of(lambda x: x.contiguous(), x)["bytes"] == 0

    def write(x, y):
        x[3] = y
    assert cost_of(write, x, meta(32))["bytes"] == 2 * 4 * 32
    assert cost_of(lambda: torch.empty(1024, device="meta")) == {
        "flops": 0, "bytes": 0, "bytes_unfused": 0, "matmul_flops": 0}


def test_the_same_count_on_the_cpu_and_on_meta():
    """What an op counts depends on its shapes alone: real CPU tensors and
    ``meta`` ones of the same shapes count the same."""
    def f(a, b):
        y = torch.softmax(a @ b, -1)
        return y.t().contiguous().sum(0), y[torch.tensor([0, 2])]
    assert cost_of(f, torch.randn(16, 8), torch.randn(8, 12)) == \
        cost_of(f, meta(16, 8), meta(8, 12))


def test_roofline_terms_and_dominance():
    r = Roofline(arch="x", shape="y", mesh="1x1", chips=1,
                 hlo_flops=hw.PEAK_FLOPS_BF16,               # 1 s compute
                 hlo_bytes=hw.HBM_BW * 0.5,                  # 0.5 s memory
                 coll_bytes=hw.ICI_BW_PER_LINK * hw.ICI_LINKS * 0.25,
                 model_flops=0.8 * hw.PEAK_FLOPS_BF16)
    assert r.dominant == "compute"
    assert r.t_bound == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(0.25)
    assert r.mfu_at_bound == pytest.approx(0.8)
    assert r.useful_fraction == pytest.approx(0.8)


def test_the_collective_term_is_not_counted_on_a_mesh():
    many = analyze(arch="x", shape="y", mesh_name="16x16", chips=256,
                   model_flops=1.0, global_flops=256 * hw.PEAK_FLOPS_BF16,
                   global_bytes=256 * hw.HBM_BW * 2.0)
    assert many.t_collective is None and many.coll_detail["note"] == \
        NOT_COUNTED
    assert many.dominant == "memory" and many.t_bound == pytest.approx(2.0)
    one = analyze(arch="x", shape="y", mesh_name="1x1", chips=1,
                  model_flops=1.0, global_flops=hw.PEAK_FLOPS_BF16,
                  global_bytes=0.0)
    assert one.t_collective == 0.0 and one.dominant == "compute"
    assert set(one.row()) >= {"arch", "shape", "mesh", "t_compute_s",
                              "t_memory_s", "t_collective_s", "dominant",
                              "model_flops", "hlo_flops", "useful_frac",
                              "mfu_at_bound", "bytes_per_device"}


def test_h100_constants():
    assert hw.PEAK_FLOPS_BF16 == 9.89e14 and hw.PEAK_FLOPS_INT8 == 1.979e15
    assert hw.PEAK_FLOPS_FP32 == 6.7e13 and hw.HBM_BW == 3.35e12
    assert hw.SMEM_BYTES_PER_CTA < hw.SMEM_BYTES_PER_SM
    assert hw.ICI_LINKS * hw.ICI_BW_PER_LINK == 450e9     # one direction


# -- the two packages on reduced models ---------------------------------------

B, S, MAX_SEQ, POS = 2, 32, 64, 40
ARCHS = ("phi4-mini-3.8b", "qwen2-moe-a2.7b", "xlstm-125m")
KINDS = ("forward", "prefill", "decode", "train")
# port / JAX of (flops, bytes, bytes_unfused), read with the counters of
# both packages at these sizes; each ratio is held within READ_TOL of its
# reading.  Decode's FLOPs and bytes_unfused are those of the views of the
# cache that torch.einsum makes (4-6 of them a layer, each counting the
# cache's elements) beside a jaxpr's one dot_general; its bytes, of the
# copy of the KV heads out to the query heads (Phi-4-mini, Qwen2-MoE) or
# of the products over one position that aten multiplies elementwise
# (xLSTM).  xLSTM's train bytes: JAX's scan backward transposes the
# sLSTM's operands at every step, and its transposes of the recurrences'
# products run where autograd skips them.
READINGS = {
    ("phi4-mini-3.8b", "forward"): (1.0998, 0.9892, 1.9381),
    ("phi4-mini-3.8b", "prefill"): (1.1006, 0.9905, 1.9169),
    ("phi4-mini-3.8b", "decode"): (2.2589, 1.2457, 5.4166),
    ("phi4-mini-3.8b", "train"): (1.0630, 0.9076, 1.4555),
    ("qwen2-moe-a2.7b", "forward"): (1.0970, 0.9233, 1.9166),
    ("qwen2-moe-a2.7b", "prefill"): (1.0980, 0.9288, 1.8883),
    ("qwen2-moe-a2.7b", "decode"): (2.1322, 1.3719, 4.7368),
    ("qwen2-moe-a2.7b", "train"): (1.0687, 0.9372, 1.4805),
    ("xlstm-125m", "forward"): (1.0765, 0.9757, 1.8624),
    ("xlstm-125m", "prefill"): (1.0767, 0.9761, 1.8564),
    ("xlstm-125m", "decode"): (1.9518, 0.8506, 3.8782),
    ("xlstm-125m", "train"): (1.0413, 0.6334, 1.3246)}
READ_TOL = 0.01


def matmul_gap(name, kind):
    """Port minus JAX matmul FLOPs of the reduced ``name`` at (B, S), by
    what runs otherwise (the module docstring); 0 where nothing does."""
    arch = get_arch(name).reduced()
    L, H, d = arch.n_layers, arch.n_heads, arch.d_model
    if arch.family == "ssm":
        # xLSTM alternates mLSTM and sLSTM; S is one mLSTM chunk.  An
        # mLSTM product over B x S x inner (inner = H x dh) elements
        inner = int(d * arch.ssm.mlstm_proj_factor)
        dh, n_m, n_s = inner // H, L // 2, L // 2
        outer = 2 * B * S * inner
        if kind in ("forward", "prefill"):
            # the memory update's w_upd x k (no contracted dim): a mul
            return -n_m * outer
        if kind == "decode":
            # one position: y_intra, n_intra, the n update and w_upd x k
            # contract nothing or one position, and so does the memory
            # update's (k x v over one position): muls in aten
            return -n_m * (4 * 2 * B * inner + 2 * B * inner * dh)
        # train: w_upd x k a mul (its forward and two transposes); no
        # gradient of the final C and n (two transposes of k x v and of
        # the n update) nor of the zero initial C and n (one transpose of
        # q x C and of q x n); no gradient of the sLSTM's zero initial h
        return -n_m * (3 * outer + 2 * 2 * B * S * inner * dh + 2 * outer
                       + 2 * B * S * inner * dh + outer) \
            - n_s * 2 * B * d * 4 * d
    if kind != "train":
        return 0
    # JAX's kv-step checkpoint: one more forward of the two score
    # products a layer (one kv block, S <= 1024)
    gap = -L * 2 * 2 * B * H * S * S * arch.resolved_head_dim
    if arch.moe is not None:
        # torch's checkpoint reruns the combine ([E,T,d] x [T,E] -> [T,d])
        gap += L * 2 * arch.moe.n_experts * B * S * d
    return gap


def _dots(jaxpr, mult=1):
    t = 0
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "dot_general":
            t += jc._dot_flops(e) * mult
        elif name == "conv_general_dilated":
            t += jc._conv_flops(e) * mult
        elif name == "scan":
            b = e.params["jaxpr"]
            t += _dots(b.jaxpr if hasattr(b, "jaxpr") else b,
                       mult * e.params["length"])
        elif name == "cond":
            t += max(_dots(b.jaxpr) for b in e.params["branches"]) * mult
        else:
            for s in jc._sub_jaxprs(e.params):
                t += _dots(s, mult)
    return t


def jax_count(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    c = jc._jaxpr_cost(jaxpr)
    return {"flops": c.flops, "bytes": c.bytes,
            "bytes_unfused": c.bytes_unfused, "matmul_flops": _dots(jaxpr)}


def jax_side(name, kind):
    arch = jax_get_arch(name).reduced()
    params = jax.eval_shape(lambda: jax_tmod.init_params(
        jax.random.PRNGKey(0), arch))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "forward":
        return jax_count(lambda p, t: jax_tmod.forward(
            p, arch, {"tokens": t})[0], params, tok)
    if kind == "prefill":
        return jax_count(lambda p, t: jax_tmod.prefill(
            p, arch, {"tokens": t}, max_seq=MAX_SEQ), params, tok)
    if kind == "decode":
        cache = jax.eval_shape(lambda: jax_tmod.init_cache(arch, B, MAX_SEQ))
        return jax_count(lambda p, c, t: jax_tmod.decode_step(
            p, arch, c, t, jnp.int32(POS)), params, cache,
            jax.ShapeDtypeStruct((B, 1), jnp.int32))
    tcfg = JaxTrainConfig(microbatches=1)
    opt = jax.eval_shape(lambda p: jax_adamw.init(p, tcfg.adamw), params)
    return jax_count(jax_make_train_step(arch, tcfg), params, opt,
                     {"tokens": tok, "labels": tok})


def port_side(name, kind):
    arch = get_arch(name).reduced()
    params = tmod.abstract_params(arch)
    tok = meta(B, S, dtype=torch.int32)
    if kind == "forward":
        fn = lambda: tmod.forward(params, arch, {"tokens": tok})  # noqa
    elif kind == "prefill":
        fn = lambda: tmod.prefill(params, arch, {"tokens": tok},  # noqa
                                  max_seq=MAX_SEQ)
    elif kind == "decode":
        cache = tmod.init_cache(arch, B, MAX_SEQ, device="meta")
        fn = lambda: tmod.decode_step(params, arch, cache,  # noqa
                                      meta(B, 1, dtype=torch.int32), POS)
    else:
        tcfg = TrainConfig(microbatches=1)
        opt = adamw.init(params, tcfg.adamw)
        step = make_train_step(arch, tcfg)
        fn = lambda: step(params, opt, {"tokens": tok,  # noqa
                                        "labels": tok})
    return count(fn).as_dict()


@pytest.fixture
def plain_route():
    layers.set_kernel_mode(False)
    yield
    layers.set_kernel_mode(True)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ARCHS)
def test_counts_agree_with_the_jax_package(name, kind, plain_route):
    want, got = jax_side(name, kind), port_side(name, kind)
    assert got["matmul_flops"] == want["matmul_flops"] + \
        matmul_gap(name, kind)
    for key, reading in zip(("flops", "bytes", "bytes_unfused"),
                            READINGS[name, kind]):
        ratio = got[key] / want[key]
        assert abs(ratio / reading - 1) <= READ_TOL, (key, ratio, reading)
