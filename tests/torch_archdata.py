"""Helpers of the remaining-LM-families tests (``tests/test_torch_archs.py``
and ``tests/test_torch_archs_serving.py``): the seven archs at
``.reduced()``, the JAX package's params carried across, seeded feeds,
the attention-route fixture and the tolerance checks."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tmod
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers

ARCHS = ("hymba-1.5b", "xlstm-125m", "seamless-m4t-medium",
         "internvl2-26b", "gemma2-9b", "qwen2-72b", "command-r-plus-104b")
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, MAX_SEQ = 2, 32, 64


def archs(name, dtype):
    return tuple(dataclasses.replace(g(name).reduced(), dtype=dtype)
                 for g in (jax_get_arch, get_arch))


_BUILT = {}


def build(name, dtype):
    """(JAX arch, JAX params, port arch, port params), made once."""
    if (name, dtype) not in _BUILT:
        jarch, arch = archs(name, dtype)
        jparams = jax.jit(jax_tmod.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), jarch)
        _BUILT[name, dtype] = (jarch, jparams, arch, lm_params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu"))
    return _BUILT[name, dtype]


@pytest.fixture(params=["blockwise", "kernel"])
def route(request):
    """Both packages on the same attention route; restores both modes."""
    on = request.param == "kernel"
    jax_layers.set_kernel_mode(on, interpret=True)
    layers.set_kernel_mode(on)
    try:
        yield on
    finally:
        jax_layers.set_kernel_mode(False)
        layers.set_kernel_mode(True)


def seeded_feed(arch, seed, shape, labels=False):
    """Seeded tokens (and labels), with 0.01 x N(0, 1) patches or frames
    where the arch reads them, as numpy."""
    rng = np.random.default_rng(seed)
    feed = {"tokens": rng.integers(0, 128, shape).astype(np.int32)}
    if labels:
        feed["labels"] = rng.integers(0, 128, shape).astype(np.int32)
    if arch.family == "vlm":
        feed["patches"] = (0.01 * rng.normal(
            size=(shape[0], arch.n_patches, arch.d_model))).astype(
            np.float32)
    if arch.enc_dec:
        feed["frames"] = (0.01 * rng.normal(
            size=(shape[0], arch.n_frames, arch.d_model))).astype(
            np.float32)
    return feed


def as_jnp(feed):
    return {k: jnp.asarray(v) for k, v in feed.items()}


def as_torch(feed):
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in feed.items()}


def near(got: torch.Tensor, want, rel: float) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def leaf_at(tree, path):
    for p in path:
        tree = tree[p.key if hasattr(p, "key") else p.idx]
    return tree


def same_tree(tree, jtree, check):
    """``check(port leaf, JAX leaf)`` on every leaf, the two trees of the
    same structure."""
    flat = jax.tree_util.tree_leaves_with_path(jtree)
    assert len(flat) == len(pytree.tree_leaves(tree))
    for path, want in flat:
        check(leaf_at(tree, path), want)


# compiled without XLA's excess precision (see test_torch_lm_families.py):
# its fusions would keep f32 where the port rounds to bf16.  ``kernel``:
# the kernel mode the trace runs under, a static argument so that each
# mode gets a trace of its own
@functools.partial(jax.jit, static_argnums=(1, 3))
def jax_forward(params, arch, feed, kernel):
    hidden, aux = jax_tmod.forward(params, arch, feed)
    return hidden, aux.get("enc_memory")


def jax_call(fn, params, arch, feed, kernel):
    return fn.lower(params, arch, feed, kernel).compile(
        {"xla_allow_excess_precision": False})(params, feed)


