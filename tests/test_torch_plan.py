"""The port's compiler against the JAX package's: the same configuration
under the same budgets gives the same schedules, engine bindings, block,
scan and working-set tables, Eq. 2 templates and modelled throughput."""
import dataclasses

import pytest

from repro import compiler as jc
from repro.configs import cnn as jcfg
from repro_torch import compiler as tc
from repro_torch.configs import cnn as tcfg

CASES = [
    ("resnet18", "nx2100"), ("resnet50", "nx2100"), ("vgg16", "nx2100"),
    ("mini_resnet18", "mini"), ("mini_resnet50", "mini"),
    ("mini_mobilenet", "mini"),
]
JAX_TARGETS = {"nx2100": jc.NX2100, "mini": jc.TPU_INTERPRET}
TORCH_TARGETS = {"nx2100": tc.NX2100, "mini": tc.MINI}


def _cfg(module, name):
    if name.startswith("mini_"):
        return getattr(module, name)()
    return module.get_cnn(name)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def pair(request):
    name, target = request.param
    return (jc.compile(_cfg(jcfg, name), JAX_TARGETS[target]),
            tc.compile(_cfg(tcfg, name), TORCH_TARGETS[target]))


def _rows(items):
    return [dataclasses.asdict(x) for x in items]


def test_targets_share_planning_fields():
    for key in ("nx2100", "mini"):
        j, t = JAX_TARGETS[key], TORCH_TARGETS[key]
        for f in ("tb_budget", "bram_m20ks", "vmem_bytes", "n_pc", "burst",
                  "n_buffers"):
            assert getattr(j, f) == getattr(t, f), (key, f)


def test_schedules_equal(pair):
    j, t = pair
    assert _rows(t.plan.schedules) == _rows(j.plan.schedules)
    assert t.replaced == j.replaced


def test_tables_equal(pair):
    j, t = pair
    assert t.engine_table() == j.engine_table()
    assert t.block_table() == j.block_table()
    assert t.scan_table() == j.scan_table()
    assert t.vmem_report() == j.vmem_report()


def test_stats_template_equal(pair):
    j, t = pair
    assert _rows(t.stats_template(batch=2)) == _rows(j.stats_template(
        batch=2))
    t.eq2_report(batch=2).verify()


def test_throughput_equal(pair):
    j, t = pair
    assert t.throughput() == j.throughput()


def test_with_offload_equal(pair):
    j, t = pair
    convs = [s.spec.name for s in j.plan.schedules
             if s.spec.kind in ("conv", "pwconv")]
    names = sorted(set(j.plan.streamed_names) | set(convs[1:3]))
    jo, to = j.with_offload(names), t.with_offload(names)
    assert to.plan.streamed_names == jo.plan.streamed_names
    assert _rows(to.plan.schedules) == _rows(jo.plan.schedules)
    assert to.engine_table() == jo.engine_table()
    assert to.vmem_report() == jo.vmem_report()
    assert to.scan_table() == jo.scan_table()


def test_with_offload_budget_errors_agree(pair):
    """Forcing every layer pinned either compiles in both packages or is
    refused in both, naming the same offenders."""
    j, t = pair
    try:
        jo = j.with_offload([])
    except jc.TargetBudgetError as e:
        with pytest.raises(tc.TargetBudgetError) as got:
            t.with_offload([])
        assert got.value.offenders == e.offenders
        assert got.value.vmem_report == e.vmem_report
        return
    assert t.with_offload([]).engine_table() == jo.engine_table()
