"""The port's MoE FFN (``repro_torch.models.ffn``) against the JAX
package's, on the CPU.

Reduced Qwen2-MoE-A2.7B (4 experts, top-2, one shared expert, d_model
64) with the JAX package's expert weights carried across.  Both paths:
the dropless one (T <= 256) and the grouped one at one and two groups of
1024 tokens, with a capacity factor of 0.9, low enough that some choices
are dropped.  In f32 the routing (top-k experts in ``jax.lax.top_k``'s
order, capacity positions, the drop set) equals the JAX package's
exactly; outputs and the load-balance loss within 1e-4 x max|ref| in f32
and 2e-2 x max|ref| in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import ffn as jax_ffn
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import ffn
from torch_testdata import moe_routing

REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CF = 0.9
# (B, S): T = 64 (dropless), 1024 (one group), 2048 (two groups)
SHAPES = [(2, 32), (4, 256), (8, 256)]


def _cfgs(dtype, cf=CF):
    def cut(a):
        a = a.reduced()
        return dataclasses.replace(a, dtype=dtype, moe=dataclasses.replace(
            a.moe, capacity_factor=cf))
    return cut(jax_get_arch("qwen2-moe-a2.7b")), cut(
        get_arch("qwen2-moe-a2.7b"))


@pytest.fixture(scope="module", params=sorted(REL_TOL))
def moe(request):
    jcfg, cfg = _cfgs(request.param)
    jp = jax_ffn.init_moe(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                               "cpu")


def _x(shape, d, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape + (d,)).astype(
        np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _near(got, want, rel):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().detach().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _jax_routing(jp, jcfg, jx, tg):
    """The JAX package's routing, by its own steps (``moe_ffn``'s router
    and ``route_group``'s positions)."""
    m = jcfg.moe
    T = jx.shape[0] * jx.shape[1]
    xg = jx.reshape(T // tg, tg, -1)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xg.astype(jnp.float32),
                                      jp["router"]), axis=-1)
    top_p, top_e = jax.lax.top_k(probs, m.top_k)
    flat_e = top_e.reshape(T // tg, -1)
    onehot = jax.nn.one_hot(flat_e, m.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, 1) - onehot,
                              flat_e[..., None], axis=2)[..., 0]
    return np.asarray(top_e), np.asarray(pos).reshape(top_e.shape)


@pytest.mark.parametrize("shape", SHAPES[1:])
def test_routing_equals_jax_exactly(shape):
    jcfg, cfg = _cfgs("float32")
    jp = jax_ffn.init_moe(jax.random.PRNGKey(1), jcfg)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jx, x = _x(shape, cfg.d_model, "float32", seed=3)
    tg = min(ffn.MOE_GROUP, x.shape[0] * x.shape[1])
    want_e, want_pos = _jax_routing(jp, jcfg, jx, tg)
    _, _, top_e = ffn.moe_router(p, cfg, x.reshape(-1, tg, cfg.d_model))
    pos = ffn.capacity_positions(top_e, cfg.moe.n_experts)
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    cap = ffn.moe_capacity(cfg, tg)
    assert cap == max(1, int(CF * tg * cfg.moe.top_k / cfg.moe.n_experts))
    dropped = pos.numpy() >= cap
    np.testing.assert_array_equal(dropped, want_pos >= cap)
    assert dropped.any() and not dropped.all()


# every shape in f32; in bf16 the dropless path and the grouped one at two
# groups
@pytest.mark.parametrize("moe,shape", [("float32", s) for s in SHAPES]
                         + [("bfloat16", SHAPES[0]), ("bfloat16", SHAPES[2])],
                         indirect=["moe"])
def test_moe_ffn_matches_jax(moe, shape):
    """Output and load-balance loss, shared expert included."""
    jcfg, jp, cfg, p = moe
    assert "shared" in p and p["router"].dtype == torch.float32
    jx, x = _x(shape, cfg.d_model, cfg.dtype)
    # jitted: eagerly the JAX package's dispatch costs seconds
    want, want_aux = jax.jit(jax_ffn.moe_ffn, static_argnums=(1, 3))(
        jp, jcfg, jx, jcfg.act)
    got, aux = ffn.moe_ffn(p, cfg, x, cfg.act)
    assert got.dtype == x.dtype and got.shape == x.shape
    rel = REL_TOL[cfg.dtype]
    _near(got, want, rel)
    assert abs(float(aux) - float(want_aux)) <= rel * abs(float(want_aux))


def test_dropped_choices_add_nothing():
    """A token whose every choice is dropped gets the shared expert only."""
    jcfg, cfg = _cfgs("float32", cf=0.25)
    jp = jax_ffn.init_moe(jax.random.PRNGKey(2), jcfg)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    _, x = _x((4, 256), cfg.d_model, "float32", seed=5)
    _, _, top_e = ffn.moe_router(p, cfg, x.reshape(1, 1024, -1))
    pos = ffn.capacity_positions(top_e, cfg.moe.n_experts)
    lost = (pos >= ffn.moe_capacity(cfg, 1024)).all(-1)[0]
    assert lost.any()
    y, _ = ffn.moe_ffn(p, cfg, x, cfg.act)
    shared = ffn.ffn(p["shared"], x.reshape(1, 1024, -1), cfg.act)[0]
    torch.testing.assert_close(y.reshape(1024, -1)[lost], shared[lost],
                               rtol=0, atol=0)


def test_top_k_breaks_ties_as_jax():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25] * 4, [0.1, 0.4, 0.1, 0.4]],
                     np.float32)
    for k in (1, 2, 3):
        want_p, want_e = jax.lax.top_k(jnp.asarray(probs), k)
        p, e = ffn.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(e.numpy(), np.asarray(want_e))
        np.testing.assert_array_equal(p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2]])
def test_forced_route_is_the_router_own(moe, shape):
    """``moe_routing`` (which the tests and the card check use to hold one
    path against another under one routing) reads the router's own top-k,
    and forcing that back changes nothing; forcing other experts does."""
    _, _, cfg, p = moe
    _, x = _x(shape, cfg.d_model, cfg.dtype, seed=7)
    with moe_routing() as taken:
        y, aux = ffn.moe_ffn(p, cfg, x, cfg.act)
    top_e = ffn.moe_router(p, cfg, x.reshape(-1, cfg.d_model))[2]
    assert len(taken) == 1 and torch.equal(taken[0], top_e)
    with moe_routing(taken) as again:
        yf, auxf = ffn.moe_ffn(p, cfg, x, cfg.act)
    assert torch.equal(y, yf) and torch.equal(aux, auxf)
    assert torch.equal(again[0], top_e)
    with moe_routing([top_e.flip(-1).roll(1, 0)]):
        yo, _ = ffn.moe_ffn(p, cfg, x, cfg.act)
    assert not torch.equal(y, yo)


def test_aux_loss_matches_jax():
    rng = np.random.default_rng(4)
    probs = rng.dirichlet(np.ones(6), size=50).astype(np.float32)
    top_e = np.argsort(-probs, -1)[:, :2].astype(np.int32)
    want = jax_ffn._aux_loss(jnp.asarray(probs), jnp.asarray(top_e), 6)
    got = ffn._aux_loss(torch.from_numpy(probs),
                        torch.from_numpy(top_e).long(), 6)
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)
