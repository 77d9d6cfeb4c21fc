"""The port's GPipe training step (``core/dataflow.py::gpipe_train_step``)
on CPU stage meshes.

The JAX package's ``gpipe_train_step`` needs one device a stage, so it
runs in one subprocess with 8 forced host devices on the toy of
``tests/test_dataflow.py`` (16 tanh layers of width 8, 4 microbatches of
2) at S = 2, 4 and 8, from the same numpy inputs; the port runs on
``["cpu"] * S``.  Held: loss and grads within ``FLOAT_TOL`` of the JAX
package's (its ring's ``ppermute`` and ``psum`` round apart from the
port's products and tanh), bit for bit the port's own sequential
autograd over the same stages, reduced Phi-4-mini's layers (kernel mode
on, the flash call's plain versions) through 2 stages bit for bit the
sequential walk, ``pipeline_apply``'s errors, and no ``.grad`` and no
change on the caller's tensors.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro_torch.configs import get_arch
from repro_torch.core.dataflow import gpipe_train_step, split_stages
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models import transformer as tmod

ROOT = pathlib.Path(__file__).resolve().parents[1]
# float32 toy against the JAX package: (rtol, atol), as
# tests/test_torch_dataflow.py holds the forward ring
FLOAT_TOL = (1e-5, 1e-6)
JAX_STAGES = (2, 4, 8)
L, D, M, MB = 16, 8, 4, 2

JAX_GPIPE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.core.dataflow import gpipe_train_step, split_stages

    data = np.load(sys.argv[1])
    Ws, x_mb, y_mb = (jnp.asarray(data[k]) for k in ("w", "x", "y"))

    def layer_fn(p, x):
        def body(x, w):
            return jnp.tanh(x @ w), None
        return jax.lax.scan(body, x, p["w"])[0]

    out = {}
    for S in (2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:S]), ("model",))
        step = jax.jit(lambda p, x, y, mesh=mesh: gpipe_train_step(
            layer_fn, lambda o, t: jnp.mean((o - t) ** 2), p, x, y,
            mesh=mesh))
        with mesh:
            loss, grads = step(split_stages({"w": Ws}, S), x_mb, y_mb)
        out[f"loss{S}"] = np.asarray(loss)
        out[f"grad{S}"] = np.asarray(grads["w"])
    np.savez(sys.argv[2], **out)
""")


def _toy_inputs():
    rng = np.random.default_rng(0)
    return {"w": (rng.normal(size=(L, D, D)) * 0.1).astype(np.float32),
            "x": rng.normal(size=(M, MB, D)).astype(np.float32),
            "y": rng.normal(size=(M, MB, D)).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_gpipe(tmp_path_factory):
    """The JAX package's loss and grads at S = 2, 4, 8 (one subprocess)."""
    tmp = tmp_path_factory.mktemp("gpipe")
    np.savez(tmp / "in.npz", **_toy_inputs())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", JAX_GPIPE, str(tmp / "in.npz"),
                        str(tmp / "out.npz")], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _mesh(S):
    return compat_make_mesh((S,), ("model",), devices=["cpu"] * S)


def _layer_fn(p, x):
    for w in p["w"]:
        x = torch.tanh(x @ w)
    return x


def _mse(o, y):
    return ((o - y) ** 2).mean()


def _sequential(layer_fn, loss_fn, staged, x_mb, y_mb):
    """The stages composed microbatch by microbatch under plain autograd:
    the mean loss and its grads, stacked as ``staged``."""
    leaves, spec = pytree.tree_flatten(staged)
    S = leaves[0].shape[0]
    local = [[a[s].detach().requires_grad_(True) for a in leaves]
             for s in range(S)]
    losses = []
    for m in range(x_mb.shape[0]):
        x = x_mb[m]
        for ls in local:
            x = layer_fn(pytree.tree_unflatten(ls, spec), x)
        losses.append(loss_fn(x, y_mb[m]))
    loss = torch.stack(losses).mean()
    got = torch.autograd.grad(loss, [t for ls in local for t in ls])
    n = len(leaves)
    return loss.detach(), pytree.tree_unflatten(
        [torch.stack(got[i::n]) for i in range(n)], spec)


@pytest.mark.parametrize("S", JAX_STAGES)
def test_gpipe_matches_jax_within_tolerance(S, jax_gpipe):
    t = {k: torch.from_numpy(v) for k, v in _toy_inputs().items()}
    loss, grads = gpipe_train_step(_layer_fn, _mse,
                                   split_stages({"w": t["w"]}, S), t["x"],
                                   t["y"], mesh=_mesh(S))
    np.testing.assert_allclose(loss.numpy(), jax_gpipe[f"loss{S}"],
                               rtol=FLOAT_TOL[0], atol=FLOAT_TOL[1])
    assert grads["w"].shape == (S, L // S, D, D)
    np.testing.assert_allclose(grads["w"].numpy(), jax_gpipe[f"grad{S}"],
                               rtol=FLOAT_TOL[0], atol=FLOAT_TOL[1])
    assert float(grads["w"].norm()) > 0


@pytest.mark.parametrize("S", (1, 2, 4, 8))
def test_gpipe_bit_identical_to_sequential_autograd(S):
    t = {k: torch.from_numpy(v) for k, v in _toy_inputs().items()}
    staged = split_stages({"w": t["w"]}, S)
    for M_ in (1, 3, M):
        loss, grads = gpipe_train_step(_layer_fn, _mse, staged, t["x"][:M_],
                                       t["y"][:M_], mesh=_mesh(S))
        want_loss, want = _sequential(_layer_fn, _mse, staged, t["x"][:M_],
                                      t["y"][:M_])
        assert torch.equal(loss, want_loss)
        assert torch.equal(grads["w"], want["w"])


def test_gpipe_leaves_the_callers_tensors_alone():
    t = {k: torch.from_numpy(v) for k, v in _toy_inputs().items()}
    w = t["w"].reshape(4, L // 4, D, D).clone().requires_grad_(True)
    before = w.detach().clone()
    gpipe_train_step(_layer_fn, _mse, {"w": w}, t["x"], t["y"],
                     mesh=_mesh(4))
    assert w.grad is None
    assert torch.equal(w.detach(), before)


def test_gpipe_raises_pipeline_apply_errors():
    t = {k: torch.from_numpy(v) for k, v in _toy_inputs().items()}
    with pytest.raises(ValueError, match="split_stages"):
        gpipe_train_step(_layer_fn, _mse, split_stages({"w": t["w"]}, 2),
                         t["x"], t["y"], mesh=_mesh(4))
    with pytest.raises(ValueError, match="no axis 'data'"):
        gpipe_train_step(_layer_fn, _mse, split_stages({"w": t["w"]}, 2),
                         t["x"], t["y"], mesh=_mesh(2), axis="data")
    with pytest.raises(ValueError, match=r"\[M, mb, \.\.\.\]"):
        gpipe_train_step(_layer_fn, _mse, split_stages({"w": t["w"]}, 2),
                         torch.zeros(D), t["y"], mesh=_mesh(2))


def test_reduced_phi4_layers_bit_identical_to_sequential():
    """Reduced Phi-4-mini's decoder stack at 4 layers, kernel mode on (the
    flash call's plain forward and backward on the CPU), through 2 stages
    of the port's own layer loop: bit for bit the sequential walk."""
    import dataclasses
    arch = dataclasses.replace(get_arch("phi4-mini-3.8b").reduced(),
                               n_layers=4, dtype="float32")
    params = tmod.init_params(torch.Generator().manual_seed(0), arch, "cpu")
    B, S_ = 1, 32
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, arch.vocab_size, (M, B, S_)))
    x_mb = torch.stack([tmod.embed(params["embed"], t) for t in toks])
    y_mb = torch.from_numpy(rng.normal(size=x_mb.shape).astype(np.float32))
    positions = torch.arange(S_).expand(B, S_)

    def layer_fn(p, x):
        return tmod._scan_layers(p, arch, x, positions, None,
                                 remat=False)[0]
    staged = split_stages(params["layers"], 2)
    loss, grads = gpipe_train_step(layer_fn, _mse, staged, x_mb.detach(),
                                   y_mb, mesh=_mesh(2))
    want_loss, want = _sequential(layer_fn, _mse, staged, x_mb.detach(),
                                  y_mb)
    assert torch.equal(loss, want_loss) and torch.isfinite(loss)
    got, want = pytree.tree_leaves(grads), pytree.tree_leaves(want)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(float(g.norm()) > 0 for g in got)
