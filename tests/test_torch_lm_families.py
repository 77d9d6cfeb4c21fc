"""The port's MoE and MLA LM families against the JAX package, on the CPU.

Reduced Qwen2-MoE-A2.7B (MoE FFN with a shared expert, GQA attention
with qkv bias) and reduced DeepSeek-V2 (MoE FFN and MLA), 2 layers,
d_model 64, with the JAX package's params carried across leaf for leaf.
``forward`` hidden states and ``moe_loss`` on both attention routes (the
JAX kernel in interpret mode, the port's plain version of K9) and on
both MoE paths; ``loss_fn`` and its gradients in f32 with remat on and
off, and one ``make_train_step`` step (params and AdamW moments);
``prefill`` and teacher-forced ``decode_step``; and the f32
``ServingEngine`` tokens equal to the JAX engine's.  Tolerance: 1e-4 x
max|ref| in f32, 2e-2 x max|ref| in bf16, as ``tests/test_torch_lm.py``.
Also: ``init_params``, which draws each layer into its slice of the
stacked leaves, equals the stack of per-layer draws bit for bit, and a
config lacking its sub-config raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as jax_layers
from repro.models import mla as jax_mla
from repro.models import transformer as jax_tmod
from repro.runtime.serving import Request as JaxRequest
from repro.runtime.serving import ServingEngine as JaxServingEngine
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.models import layers
from repro_torch.models import transformer as tmod
from repro_torch.runtime.serving import Request, ServingEngine
from repro_torch.runtime.trainer import value_and_grad
from torch_archdata import check_train_step
from torch_testdata import moe_routing

ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-236b")
REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, MAX_SEQ = 2, 32, 64


def _archs(name, dtype):
    return tuple(dataclasses.replace(g(name).reduced(), dtype=dtype)
                 for g in (jax_get_arch, get_arch))


_BUILT = {}


def _build(name, dtype):
    """(JAX arch, JAX params, port arch, port params), made once."""
    if (name, dtype) not in _BUILT:
        jarch, arch = _archs(name, dtype)
        # jitted: eagerly the JAX package's dispatch costs seconds
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


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(
        np.int32)


def _near(got: torch.Tensor, want, rel: float) -> None:
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


@pytest.mark.parametrize("name", ARCHS)
def test_params_carry_across_leaf_for_leaf(name):
    jarch, jparams, arch, params = _build(name, "bfloat16")
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == len(pytree.tree_leaves(params))
    for path, leaf in flat:
        t = _leaf(params, path)
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))
    lay = params["layers"]
    assert lay["ffn"]["router"].dtype == torch.float32
    assert lay["ffn"]["shared"]["w_up"].shape[-1] == \
        arch.moe.d_ff_expert * arch.moe.n_shared
    if arch.attn_kind == "mla":
        assert lay["attn"]["q_norm"]["scale"].dtype == torch.float32
        assert "kv_norm" in lay["attn"] and "unembed" in params


def _jax_routed(jparams, jarch, toks, kernel):
    """The JAX package's forward layer by layer through its own functions
    (``_dense_layer_body``), with the top-k experts its router picks at
    each layer, ``[B*S, k]``, from the layer's FFN input.  ``kernel``: the
    kernel mode it runs under (a static argument of ``_jax_routed_jit``,
    so that each mode gets a trace of its own)."""
    B, S = toks.shape
    x = jax_tmod._embed_inputs(jparams, jarch, {"tokens": toks})
    positions = jnp.broadcast_to(jnp.arange(S), (B, S))
    routes = []
    for i in range(jarch.n_layers):
        lp = jax.tree.map(lambda a: a[i], jparams["layers"])
        h = jax_layers.rmsnorm(lp["ln1"], x, jarch.norm_eps)
        a = (jax_mla.mla_forward(lp["attn"], jarch, h, positions)
             if jarch.attn_kind == "mla" else jax_layers.attention_forward(
                 lp["attn"], jarch, h, positions))[0]
        h2 = jax_layers.rmsnorm(lp["ln2"], x + a, jarch.norm_eps)
        probs = jax.nn.softmax(jnp.einsum(
            "bsd,de->bse", h2.astype(jnp.float32), lp["ffn"]["router"]), -1)
        routes.append(jax.lax.top_k(probs, jarch.moe.top_k)[1]
                      .reshape(B * S, -1))
        x, _, _, _ = jax_tmod._dense_layer_body(jarch, x, lp, None,
                                                positions)
    return jax_layers.rmsnorm(jparams["ln_f"], x, jarch.norm_eps), routes


# the walk runs jitted (eagerly it costs seconds in dispatch), compiled
# without XLA's excess precision: its fusions would keep f32 between ops
# that the eager JAX package and the port round to bf16, which moves the
# bf16 result past 2e-2
_jax_routed_jit = jax.jit(_jax_routed, static_argnums=(1, 3))


def _jax_walk(jparams, jarch, toks, kernel):
    return _jax_routed_jit.lower(jparams, jarch, toks, kernel).compile(
        {"xla_allow_excess_precision": False})(jparams, toks)


def _row_agrees(a, b, B):
    """[B] True where every token of the row picked the same expert set
    in every layer."""
    same = np.ones(B, bool)
    for ra, rb in zip(a, b):
        same &= (np.sort(ra, -1) == np.sort(rb, -1)).all(-1).reshape(
            B, -1).all(-1)
    return same


# per arch: the MoE's dropless path (64 tokens) on both attention routes,
# its grouped path (512 tokens, one group) on the kernel route, and bf16
# (the grouped path at two groups is in tests/test_torch_moe.py)
@pytest.mark.parametrize("dtype,shape,route", [
    ("float32", (B, S), "blockwise"), ("float32", (4, 128), "kernel"),
    ("bfloat16", (B, S), "kernel")],
    ids=["f32-dropless-blockwise", "f32-grouped-kernel",
         "bf16-dropless-kernel"], indirect=["route"])
@pytest.mark.parametrize("name", ARCHS)
def test_forward_hidden_and_moe_loss_match(name, dtype, shape, route):
    """``forward`` against the JAX package's.  In f32 the routing of every
    layer equals the JAX package's exactly.  In bf16 a token's routing
    may flip where two experts' probabilities lie within rounding of each
    other, which moves its output by far more than the tolerance (even
    the JAX package's scanned forward and its layer-by-layer walk differ
    by more than the tolerance); there the reference is the walk, whose
    routing is known: every row whose routing agrees with it in every
    layer is held to the tolerance, and every row with the port's routing
    forced to it (``moe_routing``)."""
    jarch, jparams, arch, params = _build(name, dtype)
    toks = _tokens(0, shape)
    want, jaux = jax_tmod.forward(jparams, jarch,
                                  {"tokens": jnp.asarray(toks)})
    reset_launches()
    feed = {"tokens": torch.from_numpy(toks)}
    with moe_routing() as picked:
        got, aux = tmod.forward(params, arch, feed)
    assert LAUNCHES == {} and len(picked) == arch.n_layers
    jwalked, jroutes = _jax_walk(jparams, jarch, jnp.asarray(toks), route)
    jroutes = [np.asarray(r) for r in jroutes]
    rel = REL_TOL[dtype]
    agree = _row_agrees([p.numpy() for p in picked], jroutes, shape[0])
    if dtype == "float32":
        _near(got, want, rel)
        for p, j in zip(picked, jroutes):
            np.testing.assert_array_equal(p.numpy(), j)
    assert agree.any()
    want = np.asarray(jwalked, np.float32)
    scale = np.abs(want).max()
    err = np.abs(got.float().numpy() - want).max(axis=(1, 2))
    assert (err[agree] <= rel * scale).all(), (err, agree)
    with moe_routing([torch.from_numpy(r.copy()).long() for r in jroutes]):
        forced, _ = tmod.forward(params, arch, feed)
    _near(forced, want, rel)
    assert aux["moe_loss"].dtype == torch.float32
    assert abs(float(aux["moe_loss"]) - float(jaux["moe_loss"])) <= \
        rel * abs(float(jaux["moe_loss"]))


@pytest.fixture(scope="module")
def jax_grads():
    """name -> (loss, grads, batch) of the JAX package's f32 ``loss_fn``
    through the kernel route (interpret mode), computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            jarch, jparams, _, _ = _build(name, "float32")
            rng = np.random.default_rng(7)
            batch = {n: rng.integers(0, 128, (B, S)).astype(np.int32)
                     for n in ("tokens", "labels")}
            jax_layers.set_kernel_mode(True, interpret=True)
            try:
                loss, g = jax.jit(jax.value_and_grad(jax_tmod.loss_fn),
                                  static_argnums=1, static_argnames="remat")(
                    jparams, jarch, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, remat=True)
            finally:
                jax_layers.set_kernel_mode(False)
            cache[name] = (loss, g, batch)
        return cache[name]
    return get


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_fn_grads_match_jax(jax_grads, name, remat):
    """The loss with its load-balance term, and every leaf's gradient."""
    jloss, jg, batch = jax_grads(name)
    _, _, arch, params = _build(name, "float32")
    loss, g = value_and_grad(params, arch, {
        k: torch.from_numpy(v).long() for k, v in batch.items()},
        remat=remat)
    rel = REL_TOL["float32"]
    assert abs(float(loss) - float(jloss)) <= rel * abs(float(jloss))
    flat = jax.tree_util.tree_leaves_with_path(jg)
    assert len(flat) == len(pytree.tree_leaves(g))
    for path, want in flat:
        got = _leaf(g, path)
        assert got.dtype == _leaf(params, path).dtype
        _near(got, want, rel)
    assert float(np.abs(np.asarray(jg["layers"]["ffn"]["router"])).max()) > 0


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_jax(jax_grads, name):
    """The routing of f32 agrees between the packages, so nothing is
    forced."""
    jloss, jg, batch = jax_grads(name)
    _, jparams, arch, params = _build(name, "float32")
    check_train_step(jloss, jg, jparams, arch, params, {
        k: torch.from_numpy(v).long() for k, v in batch.items()})


@pytest.mark.parametrize("name", ARCHS)
def test_load_balance_term_is_in_the_loss(name):
    _, _, arch, params = _build(name, "float32")
    toks = torch.from_numpy(_tokens(8, (B, S))).long()
    batch = {"tokens": toks, "labels": toks}
    hidden, aux = tmod.forward(params, arch, batch)
    ce, _ = tmod.lm_loss(params, arch, hidden, toks,
                         torch.ones(toks.shape))
    for w in (0.0, 0.01, 0.5):
        loss = tmod.loss_fn(params, arch, batch, remat=False,
                            moe_loss_weight=w)
        want = ce + w * aux["moe_loss"] / arch.n_layers
        assert abs(float(loss) - float(want)) <= 1e-6 * float(want)


@pytest.mark.parametrize("route", ["kernel"], indirect=True)
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match(name, route):
    """In f32, where no routing flips (bf16 prefill is held through
    ``forward`` above), on the kernel route (``forward`` above holds the
    blockwise one)."""
    jarch, jparams, arch, params = _build(name, "float32")
    rel = REL_TOL["float32"]
    toks = _tokens(1, (B, S))
    # jitted here, so that each trace reads the kernel mode in force
    jlogits, jcache = jax.jit(jax_tmod.prefill, static_argnums=(1, 3))(
        jparams, jarch, {"tokens": jnp.asarray(toks)}, MAX_SEQ)
    jstep = jax.jit(jax_tmod.decode_step, static_argnums=1)
    logits, cache = tmod.prefill(params, arch,
                                 {"tokens": torch.from_numpy(toks)}, MAX_SEQ)
    assert sorted(cache) == sorted(jcache)
    assert sorted(cache) == (["c", "pe"] if arch.attn_kind == "mla"
                             else ["k", "v"])
    _near(logits, jlogits, rel)
    for n in cache:
        assert tuple(cache[n].shape) == jcache[n].shape
        _near(cache[n], jcache[n], rel)
    for i in range(4):                       # teacher-forced decode
        nxt = _tokens(10 + i, (B, 1))
        jlogits, jcache = jstep(jparams, jarch, jcache, jnp.asarray(nxt),
                                jnp.int32(S + i))
        logits, cache = tmod.decode_step(params, arch, cache,
                                         torch.from_numpy(nxt), S + i)
        _near(logits, jlogits, rel)
    for n in cache:
        _near(cache[n], jcache[n], rel)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_launcher_runs_reduced_on_cpu(name, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "9 tokens" in out


@pytest.mark.parametrize("name", ARCHS)
def test_f32_tokens_equal_jax_engine(name):
    jarch, jparams, arch, params = _build(name, "float32")
    prompts = [_tokens(20 + i, (5 + i,)) for i in range(3)]
    jeng = JaxServingEngine(jparams, jarch, batch_slots=2, max_seq=MAX_SEQ)
    want = [r.out for r in jeng.run([JaxRequest(i, p, max_new=5)
                                     for i, p in enumerate(prompts)])]
    eng = ServingEngine(params, arch, batch_slots=2, max_seq=MAX_SEQ,
                        device="cpu")
    got = [r.out for r in eng.run([Request(i, p, max_new=5)
                                   for i, p in enumerate(prompts)])]
    assert got == want
    eng.admission.assert_quiescent()


def _old_init(gen, cfg):
    """``init_params`` before it drew into slices: every layer's tree drawn
    on its own, then ``torch.stack``ed."""
    spec = {"embed": layers.embedding_spec(cfg.vocab_size, cfg.d_model,
                                           getattr(torch, cfg.dtype)),
            "ln_f": layers.rmsnorm_spec(cfg.d_model)}
    if not cfg.tie_embeddings:
        spec["unembed"] = spec["embed"]
    params = layers.draw(gen, spec, "cpu")
    per_layer = [layers.draw(gen, tmod._layer_spec(cfg), "cpu")
                 for _ in range(cfg.n_layers)]
    params["layers"] = pytree.tree_map(lambda *ls: torch.stack(ls),
                                       *per_layer)
    return params


@pytest.mark.parametrize("name", ("phi4-mini-3.8b",) + ARCHS)
def test_init_params_equals_stacked_draws_bit_for_bit(name):
    cfg = dataclasses.replace(get_arch(name).reduced(), n_layers=3)
    new = tmod.init_params(torch.Generator().manual_seed(5), cfg, "cpu")
    old = _old_init(torch.Generator().manual_seed(5), cfg)
    flat_new, spec_new = pytree.tree_flatten(new)
    flat_old, spec_old = pytree.tree_flatten(old)
    assert spec_new == spec_old
    for a, b in zip(flat_new, flat_old):
        assert a.dtype == b.dtype and a.shape == b.shape
        bits = torch.int16 if a.element_size() == 2 else torch.int32
        assert torch.equal(a.view(bits), b.view(bits))
    # the layers differ from each other: each drew its own numbers
    wq = new["layers"]["attn"]["wq" if cfg.attn_kind != "mla" else "wq_a"]
    assert not torch.equal(wq[0], wq[1])


@pytest.mark.parametrize("change", [dict(family="hybrid"),
                                    dict(family="ssm"), dict(family="moe"),
                                    dict(attn_kind="mla")])
def test_config_lacking_its_subconfig_raises(change):
    """A family or attention kind without its sub-config (``ssm``,
    ``moe``, ``mla``) raises."""
    arch = get_arch("phi4-mini-3.8b").reduced()
    with pytest.raises(ValueError, match="without"):
        tmod.init_params(torch.Generator().manual_seed(0),
                         dataclasses.replace(arch, **change), "cpu")
