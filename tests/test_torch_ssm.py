"""The port's SSM blocks (``repro_torch.models.ssm``) against the JAX
package's, on the CPU.

Mamba (reduced Hymba-1.5B: d_model 64, inner 128, state 4, conv 2),
mLSTM and sLSTM (reduced xLSTM-125M: d_model 64, 4 heads), with the JAX
package's params carried across leaf for leaf.  Each block's output and
state at S = 32 (one chunk) and S = 256 (two chunks of ``CHUNK``, the
state carried across the boundary), in f32 and bf16; S = 1 steps
chained from a state against the JAX package's steps and, for Mamba and
sLSTM, the whole sequence (mLSTM's chunk form and its step differ in
both packages, by the JAX package's design); the structured init
(``A_log``, ``dt_bias``, ``D``, zero biases) as the JAX package's.
Tolerance: 1e-4 x max|ref| in f32, 2e-2 x max|ref| in bf16, as
``tests/test_torch_lm_families.py``.  The port pairs the terms of
Mamba's in-chunk scan as ``jax.lax.associative_scan`` does
(``ssm.associative_scan``); its in-chunk cumulative sums are sequential.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers, ssm

REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B = 2
BLOCKS = {"mamba": ("hymba-1.5b", jax_ssm.init_mamba, ssm.mamba_spec),
          "mlstm": ("xlstm-125m", jax_ssm.init_mlstm, ssm.mlstm_spec),
          "slstm": ("xlstm-125m", jax_ssm.init_slstm, ssm.slstm_spec)}


def _fwd(pkg, block):
    return getattr(pkg, f"{block}_forward")


_BUILT = {}


def _build(block, dtype):
    """(JAX arch, JAX params, port arch, port params), made once."""
    if (block, dtype) not in _BUILT:
        name, init, _ = BLOCKS[block]
        jarch, arch = (dataclasses.replace(g(name).reduced(), dtype=dtype)
                       for g in (jax_get_arch, get_arch))
        jparams = jax.jit(init, static_argnums=1)(jax.random.PRNGKey(3),
                                                  jarch)
        _BUILT[block, dtype] = (jarch, jparams, arch, lm_params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu"))
    return _BUILT[block, dtype]


@functools.lru_cache(maxsize=None)
def _jax_fn(block, jarch):
    return jax.jit(lambda p, x, st: _fwd(jax_ssm, block)(p, jarch, x,
                                                         state=st))


def _x(seed, S, dtype):
    return np.random.default_rng(seed).normal(0, 1, (B, S, 64)).astype(
        np.float32).astype(jnp.dtype(dtype))


def _near(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _t(a):
    return lm_params_from_numpy(np.asarray(a), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [32, 256])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_output_and_state_match_jax(block, S, dtype):
    jarch, jparams, arch, params = _build(block, dtype)
    x = _x(S, S, dtype)
    want, jstate = _jax_fn(block, jarch)(jparams, jnp.asarray(x), None)
    got, state = _fwd(ssm, block)(params, arch, _t(x))
    rel = REL_TOL[dtype]
    assert got.dtype == getattr(torch, dtype)
    _near(got, want, rel)
    assert len(state) == len(jstate)
    for s, js in zip(state, jstate):
        assert str(s.dtype).removeprefix("torch.") == str(js.dtype)
        _near(s, js, rel)


def _chained(fwd, params, arch, x, n_seq):
    """The first ``n_seq`` positions as a sequence, then one token a step
    from the state: (the outputs concatenated, the final state)."""
    y, st = fwd(params, arch, x[:, :n_seq])
    outs = [y]
    for t in range(n_seq, x.shape[1]):
        y, st = fwd(params, arch, x[:, t:t + 1], state=st)
        outs.append(y)
    return outs, st


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_steps_chained_from_a_state_match_jax(block):
    """8 positions as a sequence, then 8 steps of one token each from its
    state: every step's output and the final state equal the JAX
    package's steps; for Mamba and sLSTM also the whole sequence of 16
    (mLSTM: see the next test)."""
    jarch, jparams, arch, params = _build(block, "float32")
    x = _x(5, 16, "float32")
    rel = REL_TOL["float32"]
    outs, st = _chained(_fwd(ssm, block), params, arch, _t(x), 8)
    jouts, jst = _chained(lambda p, a, xs, state=None: _jax_fn(block, a)(
        p, xs, state), jparams, jarch, jnp.asarray(x), 8)
    for y, jy in zip(outs, jouts):
        _near(y, jy, rel)
    for s, js in zip(st, jst):
        _near(s, js, rel)
    if block != "mlstm":
        whole, whole_state = _fwd(ssm, block)(params, arch, _t(x))
        _near(torch.cat(outs, 1), whole.numpy(), rel)
        for s, w in zip(st, whole_state):
            _near(s, w.numpy(), rel)


def test_mlstm_steps_differ_from_its_chunk_in_both_packages():
    """A property of the JAX package's mLSTM that the port keeps: inside
    a chunk the normaliser sums ``scores`` (q.k times the decay) times k,
    while the carried one sums the decay times k, so one token a step
    from a state is not the sequence evaluated as one chunk.  Both
    packages show the same gap; the first 8 positions agree."""
    jarch, jparams, arch, params = _build("mlstm", "float32")
    x = _x(5, 16, "float32")
    outs, _ = _chained(ssm.mlstm_forward, params, arch, _t(x), 8)
    whole, _ = ssm.mlstm_forward(params, arch, _t(x))
    jouts, _ = _chained(lambda p, a, xs, state=None: _jax_fn("mlstm", a)(
        p, xs, state), jparams, jarch, jnp.asarray(x), 8)
    jwhole, _ = _jax_fn("mlstm", jarch)(jparams, jnp.asarray(x), None)
    gap = np.abs(torch.cat(outs, 1).numpy() - whole.numpy())
    jgap = np.abs(np.concatenate(jouts, 1) - np.asarray(jwhole))
    scale = np.abs(np.asarray(jwhole)).max()
    assert max(gap[:, :8].max(), jgap[:, :8].max()) <= 1e-6 * scale
    assert jgap.max() > 0.1 * scale
    np.testing.assert_allclose(gap, jgap, rtol=0, atol=1e-4 * jgap.max())


@functools.lru_cache(maxsize=None)
def _jax_mlstm_grad(jarch):
    """d sum(y * w) / d params of the JAX package's mLSTM, jitted."""
    return jax.jit(jax.grad(lambda p, x, w: jnp.sum(
        jax_ssm.mlstm_forward(p, jarch, x)[0] * w)))


def _mlstm_grads(forget_bias):
    """Both packages' mLSTM gradients of sum(y * w) at S = 256 (two chunks
    of CHUNK), f32, from the reduced params with the forget gates' bias
    set to ``forget_bias`` (None: the init's zeros)."""
    jarch, jparams, arch, _ = _build("mlstm", "float32")
    if forget_bias is not None:
        b = np.asarray(jparams["b_if"]).copy()
        b[jarch.n_heads:] = forget_bias
        jparams = {**jparams, "b_if": jnp.asarray(b)}
    x, w = _x(11, 256, "float32"), _x(12, 256, "float32")
    jg = _jax_mlstm_grad(jarch)(jparams, jnp.asarray(x), jnp.asarray(w))
    params = {k: v.requires_grad_(True) for k, v in lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu").items()}
    y, _ = ssm.mlstm_forward(params, arch, _t(x))
    g = torch.autograd.grad((y * _t(w)).sum(), list(params.values()))
    return {k: np.asarray(v) for k, v in jg.items()}, dict(zip(params, g))


def test_mlstm_grads_match_jax_past_a_chunk():
    """Forget gates near 1 (bias 5): the in-chunk log-weights stay small,
    and every gradient equals the JAX package's."""
    jg, g = _mlstm_grads(5.0)
    for k, want in jg.items():
        assert np.isfinite(want).all(), k
        _near(g[k], want, REL_TOL["float32"])


def test_mlstm_grads_finite_where_the_jax_package_gives_nan():
    """A deliberate difference from the JAX package.  Its chunk weighs
    ``where(mask, exp(D - m), 0)``: above the diagonal D - m sums up to a
    chunk of -log(forget) (about 0.69 a step at the init's zero bias), so
    the exp overflows past 88 and its gradient, 0 x inf, is NaN in the
    gate weights and in everything before them.  The port masks before
    the exp (``exp(where(mask, D - m, -inf))``): the same forward bit for
    bit (``test_block_output_and_state_match_jax``), finite gradients,
    and equal to the JAX package's where those are finite."""
    jg, g = _mlstm_grads(None)
    assert sorted(k for k, v in jg.items() if np.isnan(v).any()) == \
        ["b_if", "up", "w_if"]
    for k, want in jg.items():
        assert torch.isfinite(g[k]).all(), k
        if np.isfinite(want).all():
            _near(g[k], want, REL_TOL["float32"])


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_init_state_matches_jax(block):
    jarch, _, arch, _ = _build(block, "bfloat16")
    init = {"mamba": "init_mamba_state", "mlstm": "init_mlstm_state",
            "slstm": "init_slstm_state"}[block]
    want = getattr(jax_ssm, init)(jarch, 3)
    got = getattr(ssm, init)(arch, 3, "cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_spec_draws_the_jax_structure_and_fills(block):
    """The port's draw has the JAX init's leaves, shapes and dtypes; its
    structured leaves equal the JAX package's where they are not random
    (``A_log``, ``D``, zero biases) and lie in its range where they are
    (``dt_bias``)."""
    _, jparams, arch, _ = _build(block, "bfloat16")
    got = layers.draw(torch.Generator().manual_seed(0),
                      BLOCKS[block][2](arch), "cpu")
    assert sorted(got) == sorted(jparams)
    for k, want in jparams.items():
        t = got[k]
        assert tuple(t.shape) == want.shape
        assert str(t.dtype).removeprefix("torch.") == str(want.dtype)
        if k in ("A_log", "D", "conv_b", "b_if", "b"):
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(want, np.float32))
    if block == "mamba":
        dt = torch.nn.functional.softplus(got["dt_bias"])
        assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
        assert float(dt.max()) <= 1e-1 * (1 + 1e-5)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 128])
def test_associative_scan_matches_jax_pairing(n):
    """Bit for bit the JAX package's scan on a sum, whose f32 result
    depends on the pairing."""
    x = np.random.default_rng(n).normal(0, 1, (2, n, 3)).astype(np.float32)
    want = jax.lax.associative_scan(jnp.add, jnp.asarray(x), axis=1)
    got, = ssm.associative_scan(lambda a, b: [a[0] + b[0]],
                                [torch.from_numpy(x)], 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chunk_length_is_checked():
    _, _, arch, params = _build("mamba", "float32")
    with pytest.raises(ValueError, match="multiple"):
        ssm.mamba_forward(params, arch, _t(_x(0, 130, "float32")))
