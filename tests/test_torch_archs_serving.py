"""The port's remaining LM families against the JAX package, on the CPU:
the serving path.

The seven archs of ``tests/test_torch_archs.py`` at ``.reduced()``, the
JAX package's params carried across: ``prefill`` and teacher-forced
``decode_step`` in f32 on the kernel route, every cache leaf (Hymba also
with a prompt of 24 against its window of 16, so that the ring's prefill
roll is 8); the f32 ``ServingEngine`` tokens equal to the JAX engine's;
the serving launcher; the registry.  Tolerance: 1e-4 x max|ref|.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as jax_tmod
from repro.runtime.serving import Request as JaxRequest
from repro.runtime.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models import transformer as tmod
from repro_torch.runtime.serving import Request, ServingEngine
from torch_archdata import (ARCHS, MAX_SEQ, REL_TOL, B, S, as_jnp, as_torch,
                            build, near, route, same_tree,  # noqa: F401
                            seeded_feed)


@functools.lru_cache(maxsize=None)
def _jax_serving(jarch, kernel):
    """Jitted prefill and decode_step, one pair per kernel mode."""
    return (jax.jit(jax_tmod.prefill, static_argnums=(1, 3)),
            jax.jit(jax_tmod.decode_step, static_argnums=1))


@pytest.mark.parametrize("route", ["kernel"], indirect=True)
@pytest.mark.parametrize("name,prompt", [(n, S) for n in ARCHS]
                         + [("hymba-1.5b", 24)])
def test_prefill_and_decode_match(name, prompt, route):
    """In f32 on the kernel route (``forward`` above holds the blockwise
    one): the last-token logits and every cache leaf after prefill, then
    after each of 4 teacher-forced decode steps.  Hymba's ring holds its
    window of 16: a prompt of 32 rolls it by 0, one of 24 by 8."""
    jarch, jparams, arch, params = build(name, "float32")
    rel = REL_TOL["float32"]
    feed = seeded_feed(arch, 1, (B, prompt))
    jprefill, jstep = _jax_serving(jarch, route)
    jlogits, jcache = jprefill(jparams, jarch, as_jnp(feed), MAX_SEQ)
    logits, cache = tmod.prefill(params, arch, as_torch(feed), MAX_SEQ)
    assert sorted(cache) == sorted(jcache)
    if arch.family == "hybrid":
        assert cache["k"].shape[2] == arch.window
    near(logits, jlogits, rel)

    def close(got, want):
        near(got, want, rel)
    same_tree(cache, jcache, close)
    for i in range(4):
        nxt = np.random.default_rng(10 + i).integers(0, 128, (B, 1)).astype(
            np.int32)
        jlogits, jcache = jstep(jparams, jarch, jcache, jnp.asarray(nxt),
                                jnp.int32(prompt + i))
        logits, cache = tmod.decode_step(params, arch, cache,
                                         torch.from_numpy(nxt).long(),
                                         prompt + i)
        near(logits, jlogits, rel)
    same_tree(cache, jcache, close)


@pytest.mark.parametrize("name", ARCHS)
def test_f32_tokens_equal_jax_engine(name):
    jarch, jparams, arch, params = build(name, "float32")
    prompts = [np.random.default_rng(20 + i).integers(0, 128, 9 + i).astype(
        np.int32) for i in range(3)]
    jeng = JaxServingEngine(jparams, jarch, batch_slots=2, max_seq=MAX_SEQ)
    want = [r.out for r in jeng.run([JaxRequest(i, p, max_new=5)
                                     for i, p in enumerate(prompts)])]
    eng = ServingEngine(params, arch, batch_slots=2, max_seq=MAX_SEQ,
                        device="cpu")
    got = [r.out for r in eng.run([Request(i, p, max_new=5)
                                   for i, p in enumerate(prompts)])]
    assert got == want
    eng.admission.assert_quiescent()


@pytest.mark.parametrize("name", ARCHS)
def test_serve_launcher_runs_reduced_on_cpu(name, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "9 tokens" in out


def test_serve_launcher_refuses_a_short_max_seq():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "internvl2-26b", "--reduced", "--device",
                    "cpu", "--max-new", "8", "--max-seq", "15"])


def test_registry_is_the_jax_packages():
    from repro.configs import ARCH_IDS as JAX_IDS
    assert ARCH_IDS == JAX_IDS
    for name in ARCH_IDS:
        assert dataclasses.asdict(get_arch(name)) == \
            dataclasses.asdict(jax_get_arch(name)), name


def test_vlm_prompt_shorter_than_its_patches_raises():
    _, _, arch, params = build("internvl2-26b", "float32")
    feed = as_torch(seeded_feed(arch, 0, (1, arch.n_patches - 1)))
    with pytest.raises(ValueError, match="patches"):
        tmod.forward(params, arch, feed)
