"""The port's LM serving path against the JAX package, on the CPU.

Reduced Phi-4-mini (2 layers, d_model 64) in f32 and bf16, with the JAX
package's params carried across leaf for leaf (``lm_params_from_numpy``):
``forward`` hidden states, ``prefill`` logits and KV cache, and four
teacher-forced ``decode_step`` logits, with the flash-kernel route off
and on in both packages (the JAX kernel in interpret mode, the port's
plain version).  Tolerance: max |diff| <= 1e-4 x max|logit| in f32 and
2e-2 x max|logit| in bf16; the JAX package's own two routes differ by
2e-7 and 4.2e-3 of max|logit| there.  Then the port's ``ServingEngine``
on the CPU: completion, credit bound, determinism, and in f32 the same
tokens as the JAX engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tmod
from repro.runtime.serving import Request as JaxRequest
from repro.runtime.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.models import layers
from repro_torch.models import transformer as tmod
from repro_torch.runtime.serving import Request, ServingEngine

REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, MAX_SEQ = 2, 32, 64


def _build(dtype):
    """(JAX arch, JAX params, port arch, port params) in one dtype."""
    jarch = dataclasses.replace(jax_get_arch("phi4-mini-3.8b").reduced(),
                                dtype=dtype)
    arch = dataclasses.replace(get_arch("phi4-mini-3.8b").reduced(),
                               dtype=dtype)
    jparams = jax_tmod.init_params(jax.random.PRNGKey(0), jarch)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jarch, jparams, arch, params


@pytest.fixture(scope="module", params=sorted(REL_TOL))
def model(request):
    return _build(request.param)


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


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(
        np.int32)


def _near(got: torch.Tensor, want, rel: float, scale=None) -> None:
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max() if scale is None else scale
    err = np.abs(got.float().numpy() - want).max()
    assert err <= rel * scale, (err, scale)


def test_params_carry_across_leaf_for_leaf(model):
    jarch, jparams, arch, params = model
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == len(jax.tree.leaves(params))
    for path, leaf in flat:
        t = params
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert params["layers"]["attn"]["wq"].shape[0] == arch.n_layers


def test_forward_hidden_matches(model, route):
    jarch, jparams, arch, params = model
    toks = _tokens(0, (B, S))
    want, _ = jax_tmod.forward(jparams, jarch, {"tokens": jnp.asarray(toks)})
    reset_launches()
    got, _ = tmod.forward(params, arch, {"tokens": torch.from_numpy(toks)})
    assert LAUNCHES == {}
    _near(got, want, REL_TOL[arch.dtype])


def test_prefill_and_decode_match(model, route):
    jarch, jparams, arch, params = model
    rel = REL_TOL[arch.dtype]
    toks = _tokens(1, (B, S))
    jlogits, jcache = jax_tmod.prefill(jparams, jarch,
                                       {"tokens": jnp.asarray(toks)}, MAX_SEQ)
    logits, cache = tmod.prefill(params, arch,
                                 {"tokens": torch.from_numpy(toks)}, MAX_SEQ)
    assert logits.dtype == torch.float32 and logits.shape == jlogits.shape
    _near(logits, jlogits, rel)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jcache[name].shape
        _near(cache[name], jcache[name], rel)
    for i in range(4):                       # teacher-forced decode
        nxt = _tokens(10 + i, (B, 1))
        jlogits, jcache = jax_tmod.decode_step(
            jparams, jarch, jcache, jnp.asarray(nxt), jnp.int32(S + i))
        logits, cache = tmod.decode_step(params, arch, cache,
                                         torch.from_numpy(nxt), S + i)
        _near(logits, jlogits, rel)


@pytest.mark.parametrize("seq,calls", [(32, 2), (130, 0)])
def test_kernel_route_taken_only_where_the_rule_holds(model, monkeypatch,
                                                      seq, calls):
    """Kernel mode is on by default.  S = 32 meets the rule (S % min(128,
    S) == 0) in both layers; S = 130 does not, and the blockwise route
    runs, as in the JAX package."""
    _, _, arch, params = model
    assert layers.kernel_mode_enabled()
    seen = []
    flash = layers._flash_call

    def counting(*args, **kw):
        seen.append(args[0].shape)
        return flash(*args, **kw)

    monkeypatch.setattr(layers, "_flash_call", counting)
    toks = torch.from_numpy(_tokens(2, (1, seq)))
    h, _ = tmod.forward(params, arch, {"tokens": toks})
    assert len(seen) == calls
    assert torch.isfinite(h.float()).all()


@pytest.fixture(scope="module")
def engine(model):
    _, _, arch, params = model
    return ServingEngine(params, arch, batch_slots=2, max_seq=MAX_SEQ,
                         device="cpu")


def test_all_requests_complete(engine):
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, 100, size=6).astype(np.int32),
                    max_new=4) for i in range(5)]
    done = engine.run(reqs)
    assert len(done) == 5
    assert all(r.done and len(r.out) == 4 for r in done)
    engine.admission.assert_quiescent()


def test_credit_bound(engine):
    reqs = [Request(i, np.arange(4, dtype=np.int32), max_new=2)
            for i in range(10)]
    taken = engine.admit(reqs)
    assert len(taken) == engine.slots
    assert engine.credits == 0
    engine.admission.release(len(taken))
    engine.admission.assert_quiescent()


def test_greedy_deterministic(engine):
    p = np.arange(6, dtype=np.int32)
    a = engine.run([Request(0, p, max_new=4)])[0].out
    b = engine.run([Request(1, p, max_new=4)])[0].out
    assert a == b


def test_f32_tokens_equal_jax_engine():
    jarch, jparams, arch, params = _build("float32")
    prompts = [_tokens(20 + i, (5 + i,)) for i in range(3)]
    jeng = JaxServingEngine(jparams, jarch, batch_slots=2, max_seq=MAX_SEQ)
    want = [r.out for r in jeng.run([JaxRequest(i, p, max_new=5)
                                     for i, p in enumerate(prompts)])]
    eng = ServingEngine(params, arch, batch_slots=2, max_seq=MAX_SEQ,
                        device="cpu")
    got = [r.out for r in eng.run([Request(i, p, max_new=5)
                                   for i, p in enumerate(prompts)])]
    assert got == want
