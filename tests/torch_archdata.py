"""Helpers of the remaining-LM-families tests (``tests/test_torch_archs.py``
and ``tests/test_torch_archs_serving.py``): the seven archs at
``.reduced()``, the JAX package's params carried across, seeded feeds,
the attention-route fixture and the tolerance checks; and the one-step
train check that ``tests/test_torch_archs_grads.py`` and
``tests/test_torch_lm_families.py`` share."""
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
from repro.optim import adamw as jax_adamw
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import TrainConfig, make_train_step

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




# AdamW of the one-step train checks: the learning rate 1e-2 from the
# first step (warmup 1) and eps 1.0, which keeps the first step linear in
# the gradient.  At the default eps (1e-8) the first step is g / (|g| +
# eps): the sign of g wherever |g| exceeds eps, and ill-conditioned near
# it, where the 1e-4 x max|g| by which the two packages' gradients may
# differ moves the step by up to its own size.  A gradient that is zero in
# exact arithmetic (the key bias's: softmax ignores a shift of a query's
# scores) is rounding noise in both packages.  The update's arithmetic at
# the default eps is held bit for bit by tests/test_torch_train.py::
# test_adamw_apply_matches_jax.
STEP_ADAMW = dict(lr_peak=1e-2, warmup_steps=1, eps=1.0)
_JAX_APPLY = jax.jit(jax_adamw.apply, static_argnums=3)


def check_train_step(jloss, jgrads, jparams, arch, params, batch):
    """One ``make_train_step`` step of the port (f32, microbatches 1, remat
    on, ``STEP_ADAMW``) from a copy of ``params`` (``adamw.apply`` updates
    in place) against the JAX package's.  At microbatches 1 the JAX step
    is ``jax.value_and_grad(loss_fn)`` then ``adamw.apply``
    (``src/repro/runtime/trainer.py:57``): its loss and grads ``jloss``,
    ``jgrads`` come from the caller's ``loss_fn`` fixture (kernel route,
    remat on), and its ``adamw.apply`` runs here from ``adamw.init``, on
    the leaves flattened into one vector.  AdamW is elementwise but for
    the global norm, so that changes the step only by the order in which
    the norm sums, and it costs one XLA compile of one leaf instead of one
    of every leaf.  The
    loss and grad norm within REL_TOL relative, the step count equal, and
    every leaf of the params and of both moments within REL_TOL x
    max|ref| in its own dtype."""
    rel = REL_TOL["float32"]
    jcfg = jax_adamw.AdamWConfig(**STEP_ADAMW)
    leaves, treedef = jax.tree.flatten(jparams)
    assert all(x.dtype == jnp.float32 for x in leaves)

    def flat(tree):
        return {"all": jnp.asarray(np.concatenate(
            [np.asarray(x).ravel() for x in jax.tree.leaves(tree)]))}

    def unflat(tree):
        parts = np.split(np.asarray(tree["all"]),
                         np.cumsum([x.size for x in leaves])[:-1])
        return jax.tree.unflatten(treedef, [
            a.reshape(x.shape) for a, x in zip(parts, leaves)])
    fp = flat(jparams)
    jp, js, jm = _JAX_APPLY(flat(jgrads), jax_adamw.init(fp, jcfg), fp, jcfg)
    jp, js = unflat(jp), {"step": js["step"], "mu": unflat(js["mu"]),
                          "nu": unflat(js["nu"])}
    tcfg = TrainConfig(microbatches=1, remat=True,
                       adamw=adamw.AdamWConfig(**STEP_ADAMW))
    p0 = pytree.tree_map(torch.clone, params)
    p, s, m = make_train_step(arch, tcfg)(p0, adamw.init(p0, tcfg.adamw),
                                          batch)
    assert abs(float(m["loss"]) - float(jloss)) <= rel * abs(float(jloss))
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        rel * float(jm["grad_norm"])
    assert int(s["step"]) == int(js["step"]) == 1

    def close(got, want):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        assert torch.isfinite(got).all()
        near(got, want, rel)
    for tree, jtree in ((p, jp), (s["mu"], js["mu"]), (s["nu"], js["nu"])):
        same_tree(tree, jtree, close)
    # the step moved the weights by more than the tolerance
    moved = [float(np.abs(a - np.asarray(b)).max() / np.abs(a).max())
             for a, b in zip(jax.tree.leaves(jp), leaves)]
    assert np.median(moved) > 10 * rel, moved
