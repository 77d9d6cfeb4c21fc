"""The port's remaining LM families against the JAX package, on the CPU:
params, ``forward`` and ``loss_fn``.

The seven archs the port gained last, at ``.reduced()`` (2 layers,
d_model 64): Hymba-1.5B (attention beside Mamba, a sliding window of
16), xLSTM-125M (mLSTM / sLSTM blocks), SeamlessM4T-medium (encoder and
decoder with cross-attention), InternVL2-26B (patch embeddings in the
first 8 token slots), Gemma2-9B (local/global windows, softcaps),
Qwen2-72B (qkv bias) and Command R+ — with the JAX package's params
carried across leaf for leaf.  The port's own init against the JAX
init's structure; ``forward`` hidden states on both attention routes
(the JAX kernel in interpret mode, the port's plain version of K9).
``loss_fn`` and its gradients: ``tests/test_torch_archs_grads.py``.
The frames and patches are 0.01 x
N(0, 1), as ``tests/test_archs_smoke.py``'s.  Tolerance: 1e-4 x
max|ref| in f32, 2e-2 x max|ref| in bf16, as
``tests/test_torch_lm_families.py``.  The serving path:
``tests/test_torch_archs_serving.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.models import transformer as tmod
from torch_archdata import (ARCHS, REL_TOL, B, S, as_jnp, as_torch, build,
                            jax_call, jax_forward, leaf_at, near,
                            route, same_tree, seeded_feed)  # noqa: F401


@pytest.mark.parametrize("name", ARCHS)
def test_params_carry_across_leaf_for_leaf(name):
    jarch, jparams, arch, params = build(name, "bfloat16")

    def same(t, leaf):
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))
    same_tree(params, jparams, same)


# the leaves both packages set without a random draw
FIXED = ("scale", "A_log", "D", "conv_b", "b_if", "b", "alpha")


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_has_the_jax_structure(name):
    """The port's own draw: the JAX init's tree, shapes and dtypes, and
    its non-random leaves (norm scales, ``A_log``, ``D``, zero biases and
    mix gates) bit for bit."""
    jarch, jparams, arch, _ = build(name, "bfloat16")
    params = tmod.init_params(torch.Generator().manual_seed(1), arch, "cpu")

    def same(t, leaf):
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
    same_tree(params, jparams, same)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        if path[-1].key in FIXED:
            np.testing.assert_array_equal(
                leaf_at(params, path).float().numpy(),
                np.asarray(leaf, np.float32))


@pytest.mark.parametrize("dtype,route", [
    ("float32", "blockwise"), ("float32", "kernel"), ("bfloat16", "kernel")],
    ids=["f32-blockwise", "f32-kernel", "bf16-kernel"], indirect=["route"])
@pytest.mark.parametrize("name", ARCHS)
def test_forward_hidden_matches(name, dtype, route):
    jarch, jparams, arch, params = build(name, dtype)
    feed = seeded_feed(arch, 0, (B, S))
    want, jmem = jax_call(jax_forward, jparams, jarch, as_jnp(feed), route)
    reset_launches()
    got, aux = tmod.forward(params, arch, as_torch(feed))
    assert LAUNCHES == {}
    assert got.dtype == getattr(torch, dtype)
    rel = REL_TOL[dtype]
    near(got, want, rel)
    if arch.enc_dec:
        near(aux["enc_memory"], jmem, rel)
