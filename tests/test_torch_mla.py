"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package's, on the CPU.

Reduced DeepSeek-V2 (4 heads, kv_lora_rank 16, q_lora_rank 32, qk head
dims 16 + 8, v 16) with the JAX package's weights carried across.
Prefill through the flash route (the JAX kernel in interpret mode, the
port's plain version of K9) and through the blockwise route (kernel mode
off, and S = 130, where ``S % min(128, S) != 0`` selects it with kernel
mode on); then four teacher-forced absorbed decode steps on the latent
cache.  Tolerance: 1e-4 x max|ref| in f32, 2e-2 x max|ref| in bf16.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as jax_layers
from repro.models import mla as jax_mla
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers, mla

REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, MAX_SEQ = 2, 32, 48


@pytest.fixture(scope="module", params=sorted(REL_TOL))
def model(request):
    jcfg, cfg = (dataclasses.replace(g("deepseek-v2-236b").reduced(),
                                     dtype=request.param)
                 for g in (jax_get_arch, get_arch))
    jp = jax_mla.init_mla(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                               "cpu")


@pytest.fixture
def kernel_mode():
    """Sets both packages' kernel mode; restores the defaults."""
    def set_mode(on):
        jax_layers.set_kernel_mode(on, interpret=True)
        layers.set_kernel_mode(on)
    yield set_mode
    jax_layers.set_kernel_mode(False)
    layers.set_kernel_mode(True)


def _x(cfg, shape, seed):
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    return jnp.asarray(x).astype(cfg.dtype), torch.from_numpy(x).to(
        getattr(torch, cfg.dtype))


def _near(got, want, rel):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _prefill(model, seq, seed, monkeypatch):
    """Both packages' prefill; returns (JAX out and cache, the port's, the
    port's flash calls)."""
    jcfg, jp, cfg, p = model
    jx, x = _x(cfg, (B, seq), seed)
    pos = np.broadcast_to(np.arange(seq), (B, seq))
    # jitted (eager dispatch costs seconds), traced anew for each call so
    # that it reads the kernel mode in force
    want, wcache = jax.jit(functools.partial(jax_mla.mla_forward, jp, jcfg))(
        jx, jnp.asarray(pos))
    calls = []
    flash = layers._flash_call

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(v.shape), k.is_contiguous()))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(layers, "_flash_call", counting)
    got, cache = mla.mla_forward(p, cfg, x, torch.from_numpy(pos.copy()))
    return want, wcache, got, cache, calls


@pytest.mark.parametrize("on", [True, False], ids=["kernel", "blockwise"])
def test_prefill_matches_jax(model, kernel_mode, monkeypatch, on):
    kernel_mode(on)
    want, wcache, got, cache, calls = _prefill(model, S, 1, monkeypatch)
    cfg = model[2]
    m = cfg.mla
    rel = REL_TOL[cfg.dtype]
    _near(got, want, rel)
    for g, w in zip(cache, wcache):
        _near(g, w, rel)
    hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert calls == ([((B, S, cfg.n_heads, hd),
                       (B, S, cfg.n_heads, m.v_head_dim), True)]
                     if on else [])


def test_prefill_blockwise_where_the_rule_fails(model, kernel_mode,
                                                monkeypatch):
    """S = 130: S % min(128, S) != 0, so kernel mode on takes the
    blockwise route, in both packages."""
    kernel_mode(True)
    want, _, got, _, calls = _prefill(model, 130, 2, monkeypatch)
    assert calls == []
    _near(got, want, REL_TOL[model[2].dtype])


def test_absorbed_decode_matches_jax(model, kernel_mode, monkeypatch):
    kernel_mode(True)
    jcfg, jp, cfg, p = model
    rel = REL_TOL[cfg.dtype]
    _, wpre, _, pre, _ = _prefill(model, S, 3, monkeypatch)
    m = cfg.mla
    jc = [jnp.zeros((B, MAX_SEQ, n), jcfg.dtype).at[:, :S].set(w)
          for n, w in zip((m.kv_lora_rank, m.qk_rope_head_dim), wpre)]
    cc = [torch.zeros((B, MAX_SEQ, t.shape[-1]), dtype=t.dtype)
          for t in pre]
    for c, t in zip(cc, pre):
        c[:, :S] = t
    step = jax.jit(lambda x, pos, c, i: jax_mla.mla_forward(
        jp, jcfg, x, pos, kv_cache=c, cache_index=i))
    for i in range(4):
        jx, x = _x(cfg, (B, 1), 10 + i)
        pos = np.full((B, 1), S + i)
        want, jc = step(jx, jnp.asarray(pos), tuple(jc), jnp.int32(S + i))
        got, new = mla.mla_forward(p, cfg, x, torch.from_numpy(pos),
                                   kv_cache=tuple(cc), cache_index=S + i)
        assert all(a is b for a, b in zip(new, cc))    # written in place
        _near(got, want, rel)
        for g, w in zip(cc, jc):
            _near(g, w, rel)
