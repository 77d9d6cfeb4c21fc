"""The port's partition specs and sharding helpers against the JAX
package's, on the CPU: ``param_specs``, ``cache_specs``, AdamW's
``state_specs`` and ``cnn_param_specs`` for every arch and CNN config,
and ``dp_spec`` / ``maybe_axis`` / ``axis_size`` over a grid of inputs,
each under four sets of mesh axis sizes (the two production meshes, a
(1, 1) mesh and one where nothing divides).  Specs compare as tuples,
leaf by leaf, in the JAX package's flatten order and path spelling.
Also the production and local meshes, and ``restore_latest``'s
``shardings`` hook."""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_arch as jax_get_arch
from repro.configs.cnn import CNN_CONFIGS as JAX_CNN_CONFIGS
from repro.models import cnn as jax_cnn
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tmod
from repro.optim import adamw as jax_adamw
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.cnn import CNN_CONFIGS
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                     mesh_axis_sizes)
from repro_torch.models import cnn, layers
from repro_torch.models.layers import flatten_with_paths
from repro_torch.models import transformer as tmod
from repro_torch.optim import adamw

AXIS_SIZES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "1x1": {"data": 1, "model": 1},
    "3x5": {"data": 3, "model": 5},
}


@pytest.fixture(params=list(AXIS_SIZES))
def axes(request):
    """Both packages' mesh axis sizes set alike; cleared after."""
    sizes = AXIS_SIZES[request.param]
    jax_layers.set_mesh_axis_sizes(sizes)
    layers.set_mesh_axis_sizes(sizes)
    yield sizes
    jax_layers.set_mesh_axis_sizes({})
    layers.set_mesh_axis_sizes({})


def jax_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(jax.tree_util.keystr(kp), tuple(s)) for kp, s in flat]


def port_flat(tree):
    return [(path, tuple(s)) for path, s in flatten_with_paths(tree)]


@functools.lru_cache(maxsize=None)
def jax_abstract(name):
    return jax.eval_shape(lambda: jax_tmod.init_params(
        jax.random.PRNGKey(0), jax_get_arch(name)))


def test_same_archs():
    assert tuple(ARCH_IDS) == tuple(JAX_ARCH_IDS)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_param_specs(name, axes):
    want = jax_flat(jax_tmod.param_specs(jax_get_arch(name)))
    got = port_flat(tmod.param_specs(get_arch(name)))
    assert got == want


@pytest.mark.parametrize("name", ARCH_IDS)
def test_param_specs_cover_the_params(name):
    """One spec a leaf, as many dims as the leaf (the stacks' lead too)."""
    layers.set_mesh_axis_sizes(AXIS_SIZES["16x16"])
    try:
        arch = get_arch(name)
        params = flatten_with_paths(tmod.abstract_params(arch))
        specs = flatten_with_paths(tmod.param_specs(arch))
        assert [p for p, _ in params] == [p for p, _ in specs]
        for (path, t), (_, s) in zip(params, specs):
            assert len(s) == t.dim(), (path, tuple(t.shape), s)
    finally:
        layers.set_mesh_axis_sizes({})


@pytest.mark.parametrize("batch", [0, 1, 128])
@pytest.mark.parametrize("name", ARCH_IDS)
def test_cache_specs(name, batch, axes):
    want = jax_flat(jax_tmod.cache_specs(jax_get_arch(name), batch))
    got = port_flat(tmod.cache_specs(get_arch(name), batch))
    assert got == want


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("name", ARCH_IDS)
def test_state_specs(name, compress, axes):
    """On the JAX package's abstract params (``jax.eval_shape``); the port
    needs only their shapes."""
    abstract = jax_abstract(name)
    want = jax_flat(jax_adamw.state_specs(
        abstract, jax_tmod.param_specs(jax_get_arch(name)),
        jax_adamw.AdamWConfig(compress_int8=compress)))
    got = port_flat(adamw.state_specs(
        abstract, tmod.param_specs(get_arch(name)),
        adamw.AdamWConfig(compress_int8=compress)))
    assert got == want


@pytest.mark.parametrize("name", sorted(CNN_CONFIGS))
def test_cnn_param_specs(name, axes):
    want = jax_flat(jax_cnn.cnn_param_specs(JAX_CNN_CONFIGS[name]))
    got = port_flat(cnn.cnn_param_specs(CNN_CONFIGS[name]))
    assert got == want


def test_axis_helpers(axes):
    for batch in (0, 1, 2, 3, 5, 8, 15, 16, 32, 48, 64, 128, 256, 512,
                  1000):
        assert layers.dp_spec(batch) == jax_layers.dp_spec(batch), batch
    for dim in (1, 2, 3, 5, 7, 15, 16, 24, 30, 32, 48, 64, 96, 100, 128,
                160, 200064, 4096):
        for name in ("data", "model", "pod", ("pod", "data")):
            assert layers.maybe_axis(dim, name) == \
                jax_layers.maybe_axis(dim, name), (dim, name)
    for name in ("data", "model", "pod", "absent", ("pod", "data"),
                 ["data", "model"], ()):
        assert layers.axis_size(name) == jax_layers.axis_size(name), name


def test_spec_is_a_tuple():
    s = layers.P(None, ("pod", "data"), "model")
    assert s == (None, ("pod", "data"), "model")
    assert tuple(s) == tuple(JP(None, ("pod", "data"), "model"))
    assert layers.P() == () and repr(layers.P(None)) == "P(None,)"
    x = torch.zeros(3)
    assert layers.constrain(x, layers.P("data")) is x


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh(multi):
    try:
        mesh = make_production_mesh(multi_pod=multi)
        shape = (2, 16, 16) if multi else (16, 16)
        assert mesh.devices.shape == shape
        assert {d.type for d in mesh.devices.flat} == {"meta"}
        assert mesh_axis_sizes(mesh) == dict(zip(mesh.axis_names, shape))
        assert layers.axis_size("data") == 16
        assert layers.axis_size(("pod", "data")) == (32 if multi else 16)
    finally:
        layers.set_mesh_axis_sizes({})


def test_local_mesh_on_the_cpu():
    try:
        mesh = make_local_mesh(device="cpu")
        assert mesh.devices.shape == (1, 1)
        assert mesh.devices.flat[0] == torch.device("cpu")
        assert layers.axis_size("data") == 1
    finally:
        layers.set_mesh_axis_sizes({})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_local_mesh()


def test_restore_latest_onto_given_devices(tmp_path):
    """``shardings``: a matching tree of devices, each leaf restored onto
    its own; without it each leaf lands on its reference's device."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.arange(4).to(torch.bfloat16)}}
    ckpt.save(str(tmp_path), 3, tree)
    like = {"a": torch.zeros(2, 3),
            "b": {"c": torch.zeros(4, dtype=torch.bfloat16)}}
    step, got = ckpt.restore_latest(
        str(tmp_path), like, shardings={"a": "meta", "b": {"c": "cpu"}})
    assert step == 3
    assert got["a"].device.type == "meta" and tuple(got["a"].shape) == (2, 3)
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    step, got = ckpt.restore_latest(str(tmp_path), like)
    assert torch.equal(got["a"], tree["a"]) and got["a"].device.type == "cpu"
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_latest(str(tmp_path), like, shardings={"a": "cpu"})
