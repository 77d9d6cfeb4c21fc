"""The port's remaining LM families against the JAX package, on the CPU:
``loss_fn`` and its gradients.

The seven archs of ``tests/test_torch_archs.py`` at ``.reduced()``, the
JAX package's params carried across, in f32 on the kernel route (the JAX
kernel in interpret mode, the port's plain versions of K9-K11), with
remat on and off in the port: the loss and every leaf's gradient within
1e-4 x max|ref|.  And one ``make_train_step`` step against the JAX
package's on the same batch (SeamlessM4T's carries frames, InternVL2's
patches): the params and both AdamW moments within the same tolerance.
"""
import jax
import pytest
import torch

from repro.models import layers as jax_layers
from repro.models import transformer as jax_tmod
from repro_torch.runtime.trainer import value_and_grad
from torch_archdata import (ARCHS, REL_TOL, B, S, as_jnp, as_torch, build,
                            check_train_step, near, same_tree, seeded_feed)


@pytest.fixture(scope="module")
def jax_grads():
    """name -> (loss, grads, feed) of the JAX package's f32 ``loss_fn``
    through the kernel route (interpret mode), computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            jarch, jparams, _, _ = build(name, "float32")
            feed = seeded_feed(jarch, 7, (B, S), labels=True)
            jax_layers.set_kernel_mode(True, interpret=True)
            try:
                loss, g = jax.jit(jax.value_and_grad(jax_tmod.loss_fn),
                                  static_argnums=1, static_argnames="remat")(
                    jparams, jarch, as_jnp(feed), remat=True)
            finally:
                jax_layers.set_kernel_mode(False)
            cache[name] = (loss, g, feed)
        return cache[name]
    return get


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_fn_grads_match_jax(jax_grads, name, remat):
    jloss, jg, feed = jax_grads(name)
    _, jparams, arch, params = build(name, "float32")
    loss, g = value_and_grad(params, arch, as_torch(feed), remat=remat)
    rel = REL_TOL["float32"]
    assert abs(float(loss) - float(jloss)) <= rel * abs(float(jloss))

    def close(got, want):
        assert torch.isfinite(got).all()
        near(got, want, rel)
    same_tree(g, jg, close)


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_jax(jax_grads, name):
    jloss, jg, feed = jax_grads(name)
    _, jparams, arch, params = build(name, "float32")
    check_train_step(jloss, jg, jparams, arch, params, as_torch(feed))
