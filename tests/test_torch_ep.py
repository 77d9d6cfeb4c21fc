"""The active mesh in the port: ``with mesh:`` (``launch/mesh.py``), the
expert-parallel MoE (``models/ffn.py::_ep_available``,
``_moe_ep_shardmap``), the flash call's mesh rule
(``models/layers.py::_flash_call``) and the dry run counted inside its
mesh, on the CPU.

The JAX package's ``shard_map`` regions need one device a slot, so its
side runs in one subprocess with 8 forced host devices: ``moe_ffn`` of
reduced Qwen2-MoE and reduced DeepSeek-V2 (4 experts, top-2) in f32 at
2 x 256 tokens (past ``MOE_DENSE_T``, so the grouped path) under (1, 4),
(1, 2) and (1, 3) meshes and under none; ``attention_forward`` with the
kernel on (interpret mode) under a (2, 4) mesh at batch 2 and a (1, 4)
one, for head counts that the model axis divides and that it does not;
and the jaxpr counts of a reduced MoE arch under a (1, 4) mesh, each
``shard_map`` body charged x the mesh's size (``roofline/
jaxpr_cost.py``).  The port runs the same on meshes of ``["cpu"] * n``
(``["meta"] * n`` for the counts), one slot after another.

Held: the EP output within ``FLOAT_TOL`` of the JAX package's EP and of
the port's grouped path; the (1, 3) mesh on the grouped path in both
packages; which path the flash call takes, the same as the JAX
package's (a spy on the function), and its output within ``F32_TOL`` x
max|out| of the JAX package's; the mesh stack (outside, one slot,
nesting, an exception); the dry run's matmul FLOPs under the mesh equal
to the JAX count's, and its totals within ``READ_TOL`` of ``READINGS``.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models import ffn, layers
from repro_torch.models import transformer as tmod
from repro_torch.roofline.op_cost import count

ROOT = pathlib.Path(__file__).resolve().parents[1]
# f32 against the JAX package: (rtol, atol) of the MoE output (the
# experts' products and the combine round apart in the two packages)
FLOAT_TOL = (1e-5, 1e-5)
# attention in f32 against the JAX package, a share of max |out|, as the
# LM tests hold it
F32_TOL = 1e-4
MOE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-236b")
EP_MESHES = ((1, 4), (1, 2), (1, 3))
TOKENS = (2, 256)
# (mesh, heads, KV heads): where both divide the model axis (4) the
# kernel runs, else under the (2, 4) mesh (batch 2 split over data) the
# blockwise path; the (1, 4) mesh splits no batch, so the kernel runs
FLASH_CASES = (((2, 4), 4, 2), ((2, 4), 8, 4), ((2, 4), 4, 4),
               ((2, 4), 8, 2), ((1, 4), 4, 2))
FLASH_B, FLASH_S, FLASH_HD = 2, 128, 32
# the dry run's count of reduced Qwen2-MoE and DeepSeek-V2 (4 experts,
# the model axis 4 divides them) under a (1, 4) mesh at B x S: port / JAX
# of (flops, bytes, bytes_unfused), read with the counters of both
# packages (the module docstring of tests/test_torch_roofline.py says
# why the elementwise terms part; besides, the port's EP combine takes
# its bf16 operands to f32, where the JAX package adds bf16 partials),
# each held within READ_TOL
COUNT_B, COUNT_S = 2, 256
COUNT_KINDS = ("forward", "prefill")
READINGS = {
    ("qwen2-moe-a2.7b", "forward"): (1.0758, 1.0228, 1.4730),
    ("qwen2-moe-a2.7b", "prefill"): (1.0765, 1.0010, 1.4727),
    ("deepseek-v2-236b", "forward"): (1.0735, 1.0391, 1.4913),
    ("deepseek-v2-236b", "prefill"): (1.0737, 1.0350, 1.4907)}
READ_TOL = 0.01


def _arch(name, **kw):
    return dataclasses.replace(get_arch(name).reduced(), dtype="float32",
                               **kw)


def _moe_params(arch, seed):
    """One MoE layer's params as numpy, drawn from ``seed``."""
    m, d = arch.moe, arch.d_model
    f, E = m.d_ff_expert, m.n_experts
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    p = {"router": w(d, E), "w_gate": w(E, d, f), "w_up": w(E, d, f),
         "w_down": w(E, f, d)}
    if m.n_shared:
        fs = f * m.n_shared
        p.update({"shared.w_gate": w(d, fs), "shared.w_up": w(d, fs),
                  "shared.w_down": w(fs, d)})
    return p


def _nest(flat, lib):
    out = {}
    for k, v in flat.items():
        *head, last = k.split(".")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = lib(v)
    return out


def _attn_params(arch, seed):
    d, hd = arch.d_model, arch.resolved_head_dim
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(
            np.float32)
    return {"wq": w(d, arch.n_heads, hd), "wk": w(d, arch.n_kv_heads, hd),
            "wv": w(d, arch.n_kv_heads, hd), "wo": w(arch.n_heads, hd, d)}


def _inputs():
    """Every input of both sides, as numpy (saved for the subprocess)."""
    rng = np.random.default_rng(7)
    out = {}
    for i, name in enumerate(MOE_ARCHS):
        arch = _arch(name)
        for k, v in _moe_params(arch, 10 + i).items():
            out[f"moe/{name}/{k}"] = v
        out[f"moe/{name}/x"] = rng.normal(
            size=TOKENS + (arch.d_model,)).astype(np.float32)
    for j, (_, H, KV) in enumerate(FLASH_CASES):
        arch = _arch("phi4-mini-3.8b", n_heads=H, n_kv_heads=KV,
                     head_dim=FLASH_HD)
        for k, v in _attn_params(arch, 20 + j).items():
            out[f"attn/{j}/{k}"] = v
        out[f"attn/{j}/x"] = rng.normal(
            size=(FLASH_B, FLASH_S, arch.d_model)).astype(np.float32)
    return out


JAX_SIDE = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_arch
    from repro.models import ffn, layers
    from repro.models import transformer as tmod
    from repro.roofline import jaxpr_cost as jc
    sys.path.insert(0, sys.argv[3])
    from test_torch_ep import (COUNT_B, COUNT_KINDS, COUNT_S, EP_MESHES,
                               FLASH_B, FLASH_CASES, FLASH_HD, FLASH_S,
                               MOE_ARCHS, _nest)

    data = dict(np.load(sys.argv[1]))
    out, info = {}, {}

    def arch_of(name, **kw):
        return dataclasses.replace(get_arch(name).reduced(),
                                   dtype="float32", **kw)

    def mesh_of(shape):
        n = shape[0] * shape[1]
        return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))

    for name in MOE_ARCHS:
        arch = arch_of(name)
        pre = f"moe/{name}/"
        p = _nest({k[len(pre):]: v for k, v in data.items()
                   if k.startswith(pre) and k != pre + "x"}, jnp.asarray)
        x = jnp.asarray(data[pre + "x"])
        run = jax.jit(lambda p, x: ffn.moe_ffn(p, arch, x))
        y, aux = run(p, x)
        out[f"{name}/none"], out[f"{name}/none/aux"] = y, aux
        for shape in EP_MESHES:
            layers.set_mesh_axis_sizes({"data": shape[0],
                                        "model": shape[1]})
            with mesh_of(shape):
                ep = ffn._ep_available(arch.moe)
                y, aux = jax.jit(lambda p, x: ffn.moe_ffn(p, arch, x))(p, x)
            layers.set_mesh_axis_sizes({})
            out[f"{name}/{shape}"], out[f"{name}/{shape}/aux"] = y, aux
            info[f"{name}/{shape}"] = bool(ep)

    layers.set_kernel_mode(True, interpret=True)
    own = layers._flash_call
    took = []

    def spy(*a, **k):
        r = own(*a, **k)
        took.append(r is not None)
        return r
    layers._flash_call = spy
    for j, (shape, H, KV) in enumerate(FLASH_CASES):
        arch = arch_of("phi4-mini-3.8b", n_heads=H, n_kv_heads=KV,
                       head_dim=FLASH_HD)
        pre = f"attn/{j}/"
        p = {k[len(pre):]: jnp.asarray(v) for k, v in data.items()
             if k.startswith(pre) and k != pre + "x"}
        pos = jnp.broadcast_to(jnp.arange(FLASH_S), (FLASH_B, FLASH_S))
        layers.set_mesh_axis_sizes({"data": shape[0], "model": shape[1]})
        with mesh_of(shape):
            y, _ = jax.jit(lambda p, x: layers.attention_forward(
                p, arch, x, pos))(p, jnp.asarray(data[pre + "x"]))
        layers.set_mesh_axis_sizes({})
        out[f"attn/{j}"] = y
        info[f"attn/{j}"] = took.pop()
    layers._flash_call = own
    layers.set_kernel_mode(False)

    def dots(jaxpr, mult=1):
        t = 0
        for e in jaxpr.eqns:
            n = e.primitive.name
            if n == "dot_general":
                t += jc._dot_flops(e) * mult
            elif n == "scan":
                b = e.params["jaxpr"]
                t += dots(b.jaxpr if hasattr(b, "jaxpr") else b,
                          mult * e.params["length"])
            elif "shard_map" in n:
                size = int(np.prod(list(e.params["mesh"].shape.values())))
                for s in jc._sub_jaxprs(e.params):
                    t += dots(s, mult * size)
            else:
                for s in jc._sub_jaxprs(e.params):
                    t += dots(s, mult)
        return t

    layers.set_mesh_axis_sizes({"data": 1, "model": 4})
    for name in MOE_ARCHS:
        arch = get_arch(name).reduced()
        params = jax.eval_shape(lambda: tmod.init_params(
            jax.random.PRNGKey(0), arch))
        tok = jax.ShapeDtypeStruct((COUNT_B, COUNT_S), jnp.int32)
        for kind in COUNT_KINDS:
            if kind == "forward":
                fn = lambda p, t: tmod.forward(p, arch, {"tokens": t})[0]
            else:
                fn = lambda p, t: tmod.prefill(p, arch, {"tokens": t},
                                               max_seq=COUNT_S)
            with mesh_of((1, 4)):
                jaxpr = jax.make_jaxpr(fn)(params, tok).jaxpr
                c = jc._jaxpr_cost(jaxpr)
                info[f"count/{name}/{kind}"] = {
                    "flops": c.flops, "bytes": c.bytes,
                    "bytes_unfused": c.bytes_unfused,
                    "matmul_flops": dots(jaxpr)}
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
    with open(sys.argv[2] + ".json", "w") as f:
        json.dump(info, f)
""")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    np.savez(tmp / "in.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, str(tmp / "in.npz"),
                        str(tmp / "out.npz"), str(ROOT / "tests")],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(tmp / "out.npz.json") as f:
        info = json.load(f)
    return dict(np.load(tmp / "out.npz")), info


def _cpu_mesh(shape, device="cpu"):
    return compat_make_mesh(shape, ("data", "model"),
                            devices=[device] * (shape[0] * shape[1]))


def _moe_inputs(name):
    data, pre = _inputs(), f"moe/{name}/"
    p = _nest({k[len(pre):]: v for k, v in data.items()
               if k.startswith(pre) and k != pre + "x"}, torch.from_numpy)
    return p, torch.from_numpy(data[pre + "x"])


@pytest.fixture
def ep_calls(monkeypatch):
    """The calls of the EP region, counted by a spy."""
    calls = []
    own = ffn._moe_ep_shardmap

    def spy(*a, **k):
        calls.append(layers._current_physical_mesh())
        return own(*a, **k)
    monkeypatch.setattr(ffn, "_moe_ep_shardmap", spy)
    return calls


@pytest.mark.parametrize("shape", EP_MESHES)
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_ep_matches_jax_and_the_grouped_path(name, shape, jax_side,
                                             ep_calls):
    want, info = jax_side
    arch = _arch(name)
    p, x = _moe_inputs(name)
    grouped, g_aux = ffn.moe_ffn(p, arch, x)
    assert not ep_calls
    with _cpu_mesh(shape) as mesh:
        assert ffn._ep_available(arch.moe) == info[f"{name}/{shape}"] \
            == (arch.moe.n_experts % shape[1] == 0)
        y, aux = ffn.moe_ffn(p, arch, x)
    assert ep_calls == ([mesh] if info[f"{name}/{shape}"] else [])
    np.testing.assert_allclose(y.numpy(), want[f"{name}/{shape}"],
                               rtol=FLOAT_TOL[0], atol=FLOAT_TOL[1])
    np.testing.assert_allclose(y.numpy(), grouped.numpy(),
                               rtol=FLOAT_TOL[0], atol=FLOAT_TOL[1])
    np.testing.assert_allclose(grouped.numpy(), want[f"{name}/none"],
                               rtol=FLOAT_TOL[0], atol=FLOAT_TOL[1])
    np.testing.assert_allclose(float(aux), want[f"{name}/{shape}/aux"],
                               rtol=FLOAT_TOL[0])
    assert float(aux) == float(g_aux)
    if not info[f"{name}/{shape}"]:
        assert torch.equal(y, grouped)


def test_ep_sums_the_slots_over_several_groups(ep_calls):
    """4 x 512 tokens make 2 groups of MOE_GROUP: each slot runs every
    group, and the sum equals the grouped path within FLOAT_TOL."""
    arch = _arch("qwen2-moe-a2.7b")
    p, _ = _moe_inputs("qwen2-moe-a2.7b")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 512, arch.d_model)).astype(np.float32))
    grouped, _ = ffn.moe_ffn(p, arch, x)
    with _cpu_mesh((2, 2)):
        y, _ = ffn.moe_ffn(p, arch, x)
    assert len(ep_calls) == 1
    np.testing.assert_allclose(y.numpy(), grouped.numpy(),
                               rtol=FLOAT_TOL[0], atol=FLOAT_TOL[1])


def test_ep_runs_in_a_model_forward(ep_calls):
    """Reduced Qwen2-MoE's prefill under a (1, 4) mesh takes the EP region
    at every MoE layer, and its logits equal the grouped path's within
    F32_TOL x max|logit|."""
    arch = _arch("qwen2-moe-a2.7b")
    params = tmod.init_params(torch.Generator().manual_seed(0), arch, "cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, arch.vocab_size, TOKENS))
    want, _ = tmod.prefill(params, arch, {"tokens": toks}, TOKENS[1])
    with _cpu_mesh((1, 4)):
        got, _ = tmod.prefill(params, arch, {"tokens": toks}, TOKENS[1])
    assert len(ep_calls) == arch.n_layers
    assert float((got - want).abs().max()) <= F32_TOL * float(
        want.abs().max())


@pytest.fixture
def flash_spy(monkeypatch):
    took = []
    own = layers._flash_call

    def spy(*a, **k):
        r = own(*a, **k)
        took.append(r is not None)
        return r
    monkeypatch.setattr(layers, "_flash_call", spy)
    return took


@pytest.mark.parametrize("j", range(len(FLASH_CASES)))
def test_flash_rule_takes_the_jax_packages_path(j, jax_side, flash_spy):
    want, info = jax_side
    shape, H, KV = FLASH_CASES[j]
    arch = _arch("phi4-mini-3.8b", n_heads=H, n_kv_heads=KV,
                 head_dim=FLASH_HD)
    data, pre = _inputs(), f"attn/{j}/"
    p = {k[len(pre):]: torch.from_numpy(v) for k, v in data.items()
         if k.startswith(pre) and k != pre + "x"}
    pos = torch.arange(FLASH_S).expand(FLASH_B, FLASH_S)
    with _cpu_mesh(shape):
        y, _ = layers.attention_forward(p, arch,
                                        torch.from_numpy(data[pre + "x"]),
                                        pos)
    assert flash_spy == [info[f"attn/{j}"]]
    assert info[f"attn/{j}"] == (shape[0] == 1 or (H % shape[1] == 0
                                                   and KV % shape[1] == 0))
    ref = want[f"attn/{j}"]
    assert np.abs(y.numpy() - ref).max() <= F32_TOL * np.abs(ref).max()


def test_flash_rule_needs_an_entered_mesh(flash_spy):
    """Axis sizes recorded without an entered mesh (a launcher's specs)
    leave the kernel path alone, as the JAX package's rule does."""
    arch = _arch("phi4-mini-3.8b", head_dim=FLASH_HD)
    p = {k: torch.from_numpy(v) for k, v in _attn_params(arch, 0).items()}
    x = torch.zeros((FLASH_B, FLASH_S, arch.d_model))
    pos = torch.arange(FLASH_S).expand(FLASH_B, FLASH_S)
    layers.set_mesh_axis_sizes({"data": 2, "model": 4})
    try:
        layers.attention_forward(p, arch, x, pos)
    finally:
        layers.set_mesh_axis_sizes({})
    assert flash_spy == [True]


def test_the_mesh_stack():
    m14, m11 = _cpu_mesh((1, 4)), _cpu_mesh((1, 1))
    m24 = _cpu_mesh((2, 4))
    layers.set_mesh_axis_sizes({"data": 16, "model": 16})
    try:
        assert layers._current_physical_mesh() is None
        with m11:
            assert layers._current_physical_mesh() is None
            assert layers.axis_size("model") == 1
        with m14 as got:
            assert got is m14 and layers._current_physical_mesh() is m14
            assert layers.axis_size("model") == 4
            with m24:
                assert layers._current_physical_mesh() is m24
                assert layers.axis_size(("data", "model")) == 8
                with m11:
                    assert layers._current_physical_mesh() is None
                assert layers._current_physical_mesh() is m24
            assert layers._current_physical_mesh() is m14
            assert layers.axis_size("data") == 1
        with pytest.raises(KeyError):
            with m24:
                raise KeyError("inside")
        assert layers._current_physical_mesh() is None
        assert layers.axis_size("model") == 16
    finally:
        layers.set_mesh_axis_sizes({})


def _port_count(name, kind):
    arch = get_arch(name).reduced()
    params = tmod.abstract_params(arch)
    tok = torch.empty((COUNT_B, COUNT_S), dtype=torch.int32, device="meta")
    with _cpu_mesh((1, 4), "meta"):
        if kind == "forward":
            return count(tmod.forward, params, arch,
                         {"tokens": tok}).as_dict()
        return count(tmod.prefill, params, arch, {"tokens": tok},
                     max_seq=COUNT_S).as_dict()


@pytest.fixture
def plain_route():
    layers.set_kernel_mode(False)
    yield
    layers.set_kernel_mode(True)


@pytest.mark.parametrize("kind", COUNT_KINDS)
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_dryrun_counts_ep_as_the_jax_package(name, kind, jax_side,
                                            plain_route, ep_calls):
    _, info = jax_side
    want = info[f"count/{name}/{kind}"]
    got = _port_count(name, kind)
    assert len(ep_calls) == get_arch(name).reduced().n_layers
    assert got["matmul_flops"] == want["matmul_flops"]
    for key, reading in zip(("flops", "bytes", "bytes_unfused"),
                            READINGS[name, kind]):
        ratio = got[key] / want[key]
        assert abs(ratio / reading - 1) <= READ_TOL, (key, ratio, reading)


def test_dryrun_extrapolates_the_ep_count(plain_route, ep_calls):
    """Under a (1, 4) mesh of meta devices the EP count of a stack
    extrapolates from its first layers exactly, as without a mesh."""
    arch = dataclasses.replace(get_arch("qwen2-moe-a2.7b").reduced(),
                               n_layers=5)
    shape = ShapeConfig("small", COUNT_S, COUNT_B, "prefill")
    with _cpu_mesh((1, 4), "meta"):
        assert dryrun.extrapolated_cost(arch, shape) == \
            dryrun.step_cost(arch, shape)
    assert ep_calls
