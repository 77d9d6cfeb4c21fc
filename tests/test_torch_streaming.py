"""The port's LM placement plan (``core/streaming.py``) against the JAX
package's, on the CPU: for all ten archs on the two production meshes,
with the JAX package's budgets passed to both (16 GiB of HBM a device, a
6 GiB reserve), the same decision for every tensor path, the same bytes a
device, gather bytes a step and notes, and ``apply_plan_to_specs``'s specs
equal; ``plan_vmem_residency`` on reduced xLSTM at 64 KiB; and the JAX
package's own asserts on the port (``tests/test_streaming_plan.py``).
The port's params are ``meta`` tensors (``abstract_params``), the JAX
package's ``jax.eval_shape`` of its init."""
import functools

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jax_get_arch
from repro.core import streaming as jax_streaming
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tmod
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core import streaming
from repro_torch.models import layers
from repro_torch.models import transformer as tmod
from repro_torch.models.layers import flatten_with_paths
from repro_torch.roofline import hw

JAX_BUDGETS = dict(hbm_per_device=16 * 2**30, reserve_bytes=6 * 2**30)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(params=list(MESHES))
def mesh(request):
    sizes = MESHES[request.param]
    jax_layers.set_mesh_axis_sizes(sizes)
    layers.set_mesh_axis_sizes(sizes)
    yield sizes
    jax_layers.set_mesh_axis_sizes({})
    layers.set_mesh_axis_sizes({})


@functools.lru_cache(maxsize=None)
def jax_abstract(name):
    return jax.eval_shape(lambda: jax_tmod.init_params(
        jax.random.PRNGKey(0), jax_get_arch(name)))


def jax_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(jax.tree_util.keystr(kp), tuple(s)) for kp, s in flat]


def plans(name):
    jarch, arch = jax_get_arch(name), get_arch(name)
    jparams, params = jax_abstract(name), tmod.abstract_params(arch)
    jspecs, specs = jax_tmod.param_specs(jarch), tmod.param_specs(arch)
    jplan = jax_streaming.plan_placement(jparams, jspecs, jarch,
                                         **JAX_BUDGETS)
    plan = streaming.plan_placement(params, specs, arch, **JAX_BUDGETS)
    return (jplan, jparams, jspecs), (plan, params, specs)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_plan_equals_the_jax_package(name, mesh):
    (jplan, jparams, jspecs), (plan, params, specs) = plans(name)
    assert [(t.path, t.bytes, t.uses_per_step, t.decision)
            for t in plan.tensors] == \
        [(t.path, t.bytes, t.uses_per_step, t.decision)
         for t in jplan.tensors]
    assert plan.dp == jplan.dp
    assert plan.bytes_per_device() == jplan.bytes_per_device()
    assert plan.gather_bytes_per_step() == jplan.gather_bytes_per_step()
    assert plan.notes == jplan.notes
    got = streaming.apply_plan_to_specs(specs, plan, params)
    want = jax_streaming.apply_plan_to_specs(jspecs, jplan, jparams)
    assert [(p, tuple(s)) for p, s in flatten_with_paths(got)] \
        == jax_flat(want)
    # decisions written back where a streamed tensor could not shard
    assert [t.decision for t in plan.tensors] == \
        [t.decision for t in jplan.tensors]


def test_paths_spell_as_keystr():
    tree = {"b": [{"x": 1}, (2, 3)], "a": {"z": 4, "y": layers.P(None)}}
    assert flatten_with_paths(tree) == [
        ("['a']['y']", layers.P(None)), ("['a']['z']", 4),
        ("['b'][0]['x']", 1), ("['b'][1][0]", 2), ("['b'][1][1]", 3)]
    assert [jax.tree_util.keystr(kp) for kp, _ in
            jax.tree_util.tree_flatten_with_path(
                {"b": [{"x": 1}, (2, 3)], "a": {"z": 4, "y": 5}})[0]] == \
        [p for p, _ in flatten_with_paths(tree)]


def test_dp1_keeps_everything_replicated():
    layers.set_mesh_axis_sizes({"data": 1, "model": 1})
    jax_layers.set_mesh_axis_sizes({"data": 1, "model": 1})
    try:
        (jplan, _, _), (plan, _, _) = plans("phi4-mini-3.8b")
        assert plan.notes == jplan.notes == \
            "dp=1: streaming impossible, all replicated"
        assert not plan.streamed()
    finally:
        layers.set_mesh_axis_sizes({})
        jax_layers.set_mesh_axis_sizes({})


def test_vmem_residency_equals_the_jax_package():
    """Reduced xLSTM at a 64 KiB budget: the same map, path for path."""
    jarch, arch = (jax_get_arch("xlstm-125m").reduced(),
                   get_arch("xlstm-125m").reduced())
    jparams = jax.eval_shape(lambda: jax_tmod.init_params(
        jax.random.PRNGKey(0), jarch))
    want = jax_streaming.plan_vmem_residency(jparams, jarch,
                                             vmem_budget=64 * 2**10)
    params = tmod.abstract_params(arch)
    got = streaming.plan_vmem_residency(params, arch,
                                        vmem_budget=64 * 2**10)
    assert list(got.items()) == list(want.items())
    used = sum(t.numel() * t.element_size()
               for p, t in flatten_with_paths(params) if got[p])
    assert 0 < used <= 64 * 2**10


def test_the_default_budgets_are_the_cards():
    assert streaming.HBM_BYTES == hw.HBM_BYTES == 80 * 2**30
    assert streaming.VMEM_BYTES == hw.SM_COUNT * hw.SMEM_BYTES_PER_SM


# the JAX package's own asserts (tests/test_streaming_plan.py), on the port


def test_plan_fits_budget_command_r(mesh):
    arch = get_arch("command-r-plus-104b")
    plan = streaming.plan_placement(tmod.abstract_params(arch),
                                    tmod.param_specs(arch), arch,
                                    **JAX_BUDGETS)
    assert plan.bytes_per_device() <= 10 * 2**30
    assert len(plan.streamed()) > 0


def test_small_arch_stays_replicated(mesh):
    arch = get_arch("xlstm-125m")
    plan = streaming.plan_placement(tmod.abstract_params(arch),
                                    tmod.param_specs(arch), arch)
    assert len(plan.streamed()) == 0


def test_moe_experts_stream_first(mesh):
    arch = get_arch("deepseek-v2-236b")
    plan = streaming.plan_placement(tmod.abstract_params(arch),
                                    tmod.param_specs(arch), arch,
                                    **JAX_BUDGETS)
    streamed = {t.path for t in plan.streamed()}
    assert streamed, "deepseek must stream something"
    assert not [p for p in streamed
                if "router" in p or "ln" in p or "norm" in p]


def test_apply_plan_divisibility(mesh):
    arch = get_arch("command-r-plus-104b")
    params = tmod.abstract_params(arch)
    specs = tmod.param_specs(arch)
    plan = streaming.plan_placement(params, specs, arch, **JAX_BUDGETS)
    new = streaming.apply_plan_to_specs(specs, plan, params)
    for (path, leaf), (_, spec) in zip(flatten_with_paths(params),
                                       flatten_with_paths(new)):
        for dim, ax in zip(leaf.shape, tuple(spec)):
            if ax is not None:
                assert dim % layers.axis_size(ax) == 0, (path, spec)
