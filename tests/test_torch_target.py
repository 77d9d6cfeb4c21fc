"""The ``H100`` target: stage 5 checks every layer against the CUDA launch
plan the card runs (the plan functions are plain Python, so all of this
runs on the CPU), while ``NX2100`` and ``MINI`` keep the JAX package's
working-set check and tables."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jc
from repro.configs import cnn as jcfg
from repro_torch import compiler as tc
from repro_torch.compiler import engines
from repro_torch.configs import cnn as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.conv2d_int8.ops import (MAX_SMEM_BYTES,
                                                 STREAM_MAX_W_OUT, conv_plan,
                                                 dw_plan, stream_plan)
from repro_torch.kernels.pool_int8.ops import gap_plan, pool_plan
from repro_torch.kernels.stream_matmul.ops import MM_TM, mm_plan
from repro_torch.models.cnn import cnn_forward, cnn_input_shape
from torch_testdata import numpy_cnn_params, wide_conv_cfg

NETS = tuple(tcfg.CNN_CONFIGS)
PLAN_SMS = 132            # the H100 SXM's SMs, the plans' default


def _plan_of(sched, batch=1):
    """The launch plan the card runs for one schedule at ``batch``: what
    the engines launch, spelled out independently of ``plan_bytes``;
    raises ``ValueError`` where there is none."""
    sp = sched.spec
    geo = (batch, sp.in_h, sp.in_w, sp.c_in)
    if sp.kind == "maxpool":
        return pool_plan(*geo, sp.k_h, sp.stride)
    if sp.kind == "gap":
        return gap_plan(*geo)
    if sp.kind == "dwconv":
        return dw_plan(*geo, sp.k_h, sp.stride, sched.streamed,
                       sched.n_buffers)
    if sp.kind == "fc" and sp.in_h == sp.in_w == sp.k_h == 1:
        bk = max(d for d in range(1, 513) if sp.c_in % d == 0)
        return mm_plan(MM_TM * PLAN_SMS, sp.c_in, sp.c_out,
                       "fifo" if sched.streamed else "pinned", bk,
                       max(2, sched.n_buffers))
    conv = (sp.c_out, sp.k_h, sp.k_w, sp.stride)
    if sched.streamed:
        if sp.out_w > STREAM_MAX_W_OUT:
            raise ValueError("too wide for the streamed tier")
        return stream_plan(*geo, *conv, sched.n_buffers)
    return conv_plan(*geo, *conv)


def _smem(sched, batch=1):
    try:
        return _plan_of(sched, batch).smem_bytes
    except ValueError:
        return None


@pytest.fixture(scope="module", params=NETS)
def both(request):
    cfg = tcfg.get_cnn(request.param)
    return tc.compile(cfg, tc.NX2100), tc.compile(cfg, tc.H100)


def test_h100_is_nx2100_with_the_cards_check():
    assert tc.H100.smem_bytes == MAX_SMEM_BYTES == 232448
    assert tc.H100.checks_plans and not tc.NX2100.checks_plans
    assert not tc.MINI.checks_plans
    for f in ("tb_budget", "bram_m20ks", "n_pc", "burst", "n_buffers"):
        assert getattr(tc.H100, f) == getattr(tc.NX2100, f), f
    assert tc.get_target("h100") is tc.H100
    assert tc.DEFAULT_VMEM_BYTES == jc.NX2100.vmem_bytes


def test_h100_keeps_every_tier(both):
    nx, h = both
    assert h.streamed_names == nx.streamed_names
    assert h.replaced == ()
    assert [a.mode for a in h.assignments] == \
        [a.mode for a in nx.assignments]
    assert h.engine_table() == nx.engine_table()


def test_h100_reports_each_layers_plan_bytes(both):
    _, h = both
    want = {s.spec.name: _smem(s) for s in h.plan.schedules}
    assert h.vmem_report() == want
    assert all(v is not None and 0 <= v <= MAX_SMEM_BYTES
               for v in want.values())
    text = h.describe()
    assert "smem" in text.splitlines()[0]
    for a in h.assignments:
        assert f" {a.vmem_bytes:>10d}  " in text


def test_h100_units_claim_their_largest_member(both):
    _, h = both
    report = h.vmem_report()
    for b in h.block_assignments:
        assert b.vmem_bytes == max(report[m] for m in b.members)
    for g in h.scan_assignments:
        assert g.vmem_bytes == max(report[m] for m in g.member_names)


def test_plan_existence_does_not_depend_on_the_batch(both):
    """The convs', pools' and depthwise conv's plans exist at batch 8 and
    32, in both tiers, where they exist at batch 1 (the batch the check
    takes them at); the fc matmul's block is at its largest where the
    check takes it."""
    _, h = both
    for s in h.plan.schedules:
        for tier in (s, dataclasses.replace(s, mode="hbm")):
            if tier.streamed and s.spec.is_pool:
                continue
            fc = s.spec.kind == "fc" and s.spec.in_h == 1
            at1 = _smem(tier)
            for batch in (8, 32):
                if fc:
                    sp = s.spec
                    bk = max(d for d in range(1, 513) if sp.c_in % d == 0)
                    small = mm_plan(batch, sp.c_in, sp.c_out,
                                    "fifo" if tier.streamed else "pinned",
                                    bk, max(2, tier.n_buffers)).smem_bytes
                    assert small <= at1, (s.spec.name, batch)
                else:
                    assert (_smem(tier, batch) is None) == (at1 is None), \
                        (s.spec.name, tier.mode, batch)


@pytest.mark.parametrize("name,target", [
    ("resnet50", "nx2100"), ("mini_resnet18", "mini"),
    ("mini_resnet50", "mini"), ("mini_mobilenet", "mini")])
def test_nx2100_and_mini_still_equal_the_jax_package(name, target):
    jt = {"nx2100": jc.NX2100, "mini": jc.TPU_INTERPRET}[target]
    tt = {"nx2100": tc.NX2100, "mini": tc.MINI}[target]
    make = (lambda m: getattr(m, name)()) if name.startswith("mini_") \
        else (lambda m: m.get_cnn(name))
    j, t = jc.compile(make(jcfg), jt), tc.compile(make(tcfg), tt)
    assert t.engine_table() == j.engine_table()
    assert t.vmem_report() == j.vmem_report()
    assert t.block_table() == j.block_table()
    assert [b.vmem_bytes for b in t.block_assignments] == \
        [b.vmem_bytes for b in j.block_assignments]
    assert "vmem" in t.describe().splitlines()[0]


def test_fixture_is_pinned_under_nx2100_and_streamed_under_h100():
    cfg = wide_conv_cfg(tcfg)
    nx, h = tc.compile(cfg, tc.NX2100), tc.compile(cfg, tc.H100)
    assert nx.streamed_names == () and nx.replaced == ()
    with pytest.raises(ValueError, match="shared memory"):
        conv_plan(1, 4, 64, 2048, 16, 3, 3, 1)
    assert h.streamed_names == ("wide",) and h.replaced == ("wide",)
    assert h.vmem_report()["wide"] == \
        stream_plan(1, 4, 64, 2048, 16, 3, 3, 1, 2).smem_bytes
    assert h.engine_table()["wide"] == "conv2d_int8"
    # forced pinned, the card's check refuses it, naming the layer
    with pytest.raises(tc.TargetBudgetError, match="wide: no launch plan") \
            as err:
        h.with_offload([])
    assert err.value.offenders == ("wide",)
    assert err.value.vmem_report["wide"] is None
    # the JAX package's compile keeps it pinned too
    assert jc.compile(wide_conv_cfg(jcfg), jc.NX2100).streamed_names == ()


def test_fixture_h100_plain_run_equals_the_jax_package():
    tfix, jfix = wide_conv_cfg(tcfg), wide_conv_cfg(jcfg)
    params = numpy_cnn_params(tfix, seed=5)
    x = np.random.default_rng(6).integers(
        -127, 128, size=cnn_input_shape(tfix, 2), dtype=np.int8)
    want, jrep = jc.compile(jfix, jc.NX2100).run(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tp = params_from_numpy(params, "cpu")
    got, rep = tc.compile(tfix, tc.H100).run(tp, torch.from_numpy(x),
                                             device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, cnn_forward(tp, tfix, torch.from_numpy(x)))
    assert rep.hbm_weight_words["wide"] > 0 and not jrep.hbm_weight_words
    rep.verify()


def test_autotune_under_h100_holds_every_candidate_to_the_plans(
        monkeypatch):
    claims = []
    real = tc.Target.claim

    def spy(self, engine, spec, scheds):
        got = real(self, engine, spec, scheds)
        if self.checks_plans:
            claims.append(got)
        return got
    monkeypatch.setattr(tc.Target, "claim", spy)
    cfg = tcfg.mini_resnet18(hw=8, width=16, stages=4)
    cp = tc.compile(cfg, tc.H100, autotune=tc.AutotuneConfig(iterations=40))
    assert cp.tuning.tuned.feasible and cp.target is tc.H100
    # the search checked each evaluated candidate's every layer
    assert len(claims) >= cp.tuning.evaluations * len(cfg.layers)
    assert all(c is not None and c <= MAX_SMEM_BYTES for c in claims)
    assert cp.vmem_report() == {s.spec.name: _smem(s)
                                for s in cp.plan.schedules}
    # a seed the card cannot launch is refused, not re-placed
    with pytest.raises(tc.AutotuneError, match="wide: no launch plan"):
        tc.compile(wide_conv_cfg(tcfg), tc.H100,
                   autotune=tc.AutotuneConfig(iterations=4))


def test_engines_declare_plan_bytes():
    for name, eng in engines.registered_engines().items():
        assert callable(getattr(eng, "plan_bytes", None)), name
