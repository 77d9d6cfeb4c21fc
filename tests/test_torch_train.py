"""The port's LM training path against the JAX package, on the CPU.

Inputs are made with numpy from a seed (or drawn by the JAX package and
carried across with ``lm_params_from_numpy``) and handed to both.  The
JAX kernels run in interpret mode, the port's as their plain versions.

Tolerances, each max |diff| against a share of max |want|:

* the backward kernels (``flash_attention_bwd_plain`` against the JAX
  ``flash_attention_bwd``) and ``flash_attention_vjp``'s grads: 1e-5 in
  f32 (f32 products summed in another order) and 1e-2 in bf16 (2.5 bf16
  ulps at the maximum: the outputs round to bf16 after f32 sums taken in
  another order);
* reduced Phi-4-mini (2 layers) ``loss_fn`` grads and 3 ``Trainer`` steps:
  1e-4 in f32 and 2e-2 in bf16, as ``test_torch_lm.py``.  The JAX
  package's own two attention routes differ by 8.0e-7 (f32) and 1.7e-2
  (bf16) of the largest grad of a leaf on these inputs;
* the final params of those 3 steps: per leaf, the L2 distance from the
  JAX package's within 2e-3 (f32) and 0.3 (bf16) of the L2 distance
  training moved them.  Adam's steps are about lr times the sign of the
  gradient where it is small, so a small grad difference can flip a
  step: the JAX package's own two routes stand at 2.1e-4 and 0.11 there
  (a leaf's max |diff| is no measure: its routes differ by 1.2e-4 and
  0.80 of the largest zero-initialised RMSNorm scale after 3 steps);
* ``adamw.apply``: with clipping inactive the moments and int8 residuals
  bit for bit and the params within 1 f32 ulp (one division or square
  root that XLA evaluates otherwise, ROADMAP F1); the global norm within
  64 ulps (f32 sums in another order); with clipping active that norm
  scales every update, so 1e-5 of the max there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from repro.configs import get_arch as jax_get_arch
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import ImageDataset as JaxImageDataset
from repro.data.pipeline import TokenDataset as JaxTokenDataset
from repro.data.pipeline import device_batch as jax_device_batch
from repro.kernels.flash_attention.kernel import (
    flash_attention_bwd as jax_flash_bwd, flash_attention_kernel as
    jax_flash_kernel)
from repro.kernels.flash_attention.ops import \
    flash_attention_vjp as jax_flash_vjp
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tmod
from repro.optim import adamw as jax_adamw
from repro.runtime.trainer import TrainConfig as JaxTrainConfig
from repro.runtime.trainer import Trainer as JaxTrainer
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_arch
from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.data.pipeline import (DataConfig, ImageDataset,
                                       TokenDataset, device_batch)
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention.ops import flash_attention_vjp
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_plain
from repro_torch.models import layers
from repro_torch.models import transformer as tmod
from repro_torch.optim import adamw
from repro_torch.runtime import trainer as trainer_mod
from repro_torch.runtime.trainer import TrainConfig, Trainer, value_and_grad

KERNEL_REL = {"float32": 1e-5, "bfloat16": 1e-2}
LM_REL = {"float32": 1e-4, "bfloat16": 2e-2}
UPDATE_REL = {"float32": 2e-3, "bfloat16": 0.3}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the five ATTN_CASES of tests/test_kernels.py, then one hd != hd_v case
CASES = [
    dict(B=2, H=4, KV=4, S=256, hd=64, causal=True, window=0, softcap=0.0),
    dict(B=2, H=4, KV=2, S=256, hd=64, causal=True, window=64, softcap=0.0),
    dict(B=1, H=8, KV=2, S=128, hd=32, causal=True, window=0, softcap=50.0),
    dict(B=1, H=2, KV=2, S=128, hd=64, causal=False, window=0, softcap=0.0),
    dict(B=1, H=4, KV=1, S=128, hd=128, causal=True, window=32,
         softcap=30.0),
    dict(B=1, H=4, KV=2, S=128, hd=192, hd_v=128, causal=True, window=0,
         softcap=0.0),
]


def _near(got, want, rel: float) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _t(a, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(TDT[dtype])


def _kw(case):
    return dict(causal=case["causal"], window=case["window"],
                softcap=case["softcap"])


# ---------------------------------------------------------------------------
# the backward kernels' plain version and the differentiable wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(KERNEL_REL))
@pytest.mark.parametrize("ci", range(len(CASES)))
def test_bwd_plain_matches_pallas(ci, dtype):
    """K10/K11's plain version against the JAX kernels, on the same q, k,
    v, do and the same forward o and lse.  The JAX kernels take k and v
    repeated to H heads; the port takes them per KV head."""
    c = CASES[ci]
    rng = np.random.default_rng(ci)
    B, H, KV, S, hd = c["B"], c["H"], c["KV"], c["S"], c["hd"]
    hd_v = c.get("hd_v", hd)
    q = rng.standard_normal((B, H, S, hd), np.float32)
    k = rng.standard_normal((B, KV, S, hd), np.float32)
    v = rng.standard_normal((B, KV, S, hd_v), np.float32)
    do = rng.standard_normal((B, H, S, hd_v), np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a, JDT[dtype]) for a in (q, k, v, do))
    o, lse = jax_flash_kernel(jq, jk, jv, return_lse=True, interpret=True,
                              **_kw(c))
    rep = H // KV
    want = jax_flash_bwd(jq, jnp.repeat(jk, rep, 1), jnp.repeat(jv, rep, 1),
                         o, lse, jdo, interpret=True, **_kw(c))
    reset_launches()
    got = flash_attention_bwd_plain(
        *(_t(a, dtype) for a in (jq, jk, jv, o)),
        torch.from_numpy(np.array(lse)), _t(jdo, dtype), **_kw(c))
    assert LAUNCHES == {}
    for g, w in zip(got, want):
        assert g.dtype == TDT[dtype] and tuple(g.shape) == w.shape
        _near(g, w, KERNEL_REL[dtype])


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0), (False, 5)])
def test_plain_tile_skip_is_the_mask(causal, window):
    """The plain backward skips a tile by a rule on the host; it must be
    exactly 'the mask lets no element of the tile through'."""
    from repro_torch.kernels.flash_attention.ref import _mask, _tile_visible
    for bq, bk in ((4, 4), (4, 8), (8, 2)):
        for q0 in range(0, 24, bq):
            for k0 in range(0, 24, bk):
                want = bool(_mask(torch.arange(q0, q0 + bq),
                                  torch.arange(k0, k0 + bk), causal,
                                  window).any())
                assert _tile_visible(q0, bq, k0, bk, causal,
                                     window) == want, (q0, k0, bq, bk)


@pytest.mark.parametrize("dtype", sorted(KERNEL_REL))
@pytest.mark.parametrize("ci", [1, 4])
def test_vjp_grads_match_jax(ci, dtype):
    """flash_attention_vjp in model layout with GQA: the output and the
    grads of sum(o * w) against jax.grad of the JAX wrapper."""
    c = CASES[ci]
    rng = np.random.default_rng(50 + ci)
    B, H, KV, S, hd = c["B"], c["H"], c["KV"], c["S"], c["hd"]
    q = rng.standard_normal((B, S, H, hd), np.float32)
    k = rng.standard_normal((B, S, KV, hd), np.float32)
    v = rng.standard_normal((B, S, KV, hd), np.float32)
    w = rng.standard_normal((B, S, H, hd), np.float32)
    bq = min(128, S)

    def jloss(q, k, v):
        o = jax_flash_vjp(q, k, v, c["causal"], c["window"], c["softcap"],
                          bq, bq, True)
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(
        *(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)))
    tq, tk, tv = (_t(a, dtype).requires_grad_(True) for a in (q, k, v))
    o = flash_attention_vjp.apply(tq, tk, tv, c["causal"], c["window"],
                                  c["softcap"])
    (o.float() * torch.from_numpy(w)).sum().backward()
    _near(o, jo, KERNEL_REL[dtype])
    for t, want in zip((tq, tk, tv), jg):
        assert t.grad.dtype == TDT[dtype]
        _near(t.grad, want, KERNEL_REL[dtype])


# ---------------------------------------------------------------------------
# loss_fn on reduced Phi-4-mini
# ---------------------------------------------------------------------------


def _archs(dtype):
    return (dataclasses.replace(jax_get_arch("phi4-mini-3.8b").reduced(),
                                dtype=dtype),
            dataclasses.replace(get_arch("phi4-mini-3.8b").reduced(),
                                dtype=dtype))


@pytest.fixture(scope="module")
def jax_grads():
    """(dtype, route) -> (JAX params, loss, grads, batch), computed once."""
    cache = {}

    def get(dtype, on):
        if (dtype, on) not in cache:
            jarch, _ = _archs(dtype)
            jparams = jax_tmod.init_params(jax.random.PRNGKey(0), jarch)
            rng = np.random.default_rng(7)
            batch = {n: rng.integers(0, 128, (2, 32)).astype(np.int32)
                     for n in ("tokens", "labels")}
            jax_layers.set_kernel_mode(on, interpret=True)
            try:
                loss, g = jax.value_and_grad(jax_tmod.loss_fn)(
                    jparams, jarch, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, remat=True)
            finally:
                jax_layers.set_kernel_mode(False)
            cache[dtype, on] = (jparams, loss, g, batch)
        return cache[dtype, on]
    return get


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("route", ["blockwise", "kernel"])
@pytest.mark.parametrize("dtype", sorted(LM_REL))
def test_loss_fn_grads_match_jax(jax_grads, dtype, route, remat):
    on = route == "kernel"
    jparams, jloss, jg, batch = jax_grads(dtype, on)
    _, arch = _archs(dtype)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    layers.set_kernel_mode(on)
    try:
        loss, g = value_and_grad(
            params, arch, {k: torch.from_numpy(v).long()
                           for k, v in batch.items()}, remat=remat)
    finally:
        layers.set_kernel_mode(True)
    rel = LM_REL[dtype]
    assert abs(float(loss) - float(jloss)) <= rel * abs(float(jloss))
    flat = jax.tree_util.tree_leaves_with_path(jg)
    assert len(flat) == len(pytree.tree_leaves(g))
    for path, want in flat:
        got = g
        for p in path:
            got = got[p.key]
        assert got.dtype == params_dtype(params, path)
        _near(got, want, rel)


def params_dtype(params, path):
    t = params
    for p in path:
        t = t[p.key]
    return t.dtype


def test_remat_runs_each_layer_twice(monkeypatch):
    """With remat each layer's forward runs again in the backward: two
    attention calls per layer and step, and the same grads."""
    _, arch = _archs("float32")
    params = tmod.init_params(torch.Generator().manual_seed(0), arch, "cpu")
    batch = {"tokens": torch.randint(0, 128, (2, 32)),
             "labels": torch.randint(0, 128, (2, 32))}
    calls = []
    flash = layers._flash_call

    def counting(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return flash(*a, **kw)

    monkeypatch.setattr(layers, "_flash_call", counting)
    _, g0 = value_and_grad(params, arch, batch, remat=False)
    assert len(calls) == arch.n_layers
    calls.clear()
    _, g1 = value_and_grad(params, arch, batch, remat=True)
    assert len(calls) == 2 * arch.n_layers and all(calls)
    for a, b in zip(pytree.tree_leaves(g0), pytree.tree_leaves(g1)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _tree(rng, scale=1.0):
    return {"layers": {"w": rng.standard_normal((3, 16, 24)) * scale},
            "b": rng.standard_normal((40,)) * scale,
            "c": rng.standard_normal((8, 8)) * scale}


def _ulps(want, got: torch.Tensor) -> int:
    a = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    b = got.float().numpy().view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("clip", [1e6, 1.0])
@pytest.mark.parametrize("opts", [{}, {"compress_int8": True},
                                  {"grad_wire_bf16": True},
                                  {"compress_int8": True,
                                   "grad_wire_bf16": True}])
@pytest.mark.parametrize("dtype", sorted(LM_REL))
def test_adamw_apply_matches_jax(dtype, opts, clip):
    """Four steps through the warmup and the cosine decay, from a JAX
    state carried across by adamw_state_from_numpy."""
    cfg = dict(clip_norm=clip, lr_peak=1e-2, warmup_steps=2, total_steps=5,
               **opts)
    jcfg, cfg = jax_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    rng = np.random.default_rng(3)
    jp = jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), _tree(rng))
    js = jax_adamw.init(jp, jcfg)
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    s = adamw_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert s["step"].dtype == torch.int32 and s["step"].dim() == 0
    for _ in range(4):
        jg = jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]),
                          _tree(rng, 0.3))
        g = lm_params_from_numpy(jax.tree.map(np.asarray, jg), "cpu")
        jp, js, jm = jax_adamw.apply(jg, js, jp, jcfg)
        p, s, m = adamw.apply(g, s, p, cfg)
        assert int(s["step"]) == int(js["step"])
        assert _ulps(jm["lr"], m["lr"]) == 0
        assert _ulps(jm["grad_norm"], m["grad_norm"]) <= 64
        keys = ["mu", "nu"] + (["residual"] if "compress_int8" in opts
                               else [])
        for key in keys:
            for want, got in zip(jax.tree.leaves(js[key]),
                                 pytree.tree_leaves(s[key])):
                if clip > 1e5:
                    assert _ulps(want, got) == 0, key
                else:
                    _near(got, want, 1e-5)
        for want, got in zip(jax.tree.leaves(jp), pytree.tree_leaves(p)):
            assert got.dtype == TDT[dtype]
            if clip > 1e5:
                assert _ulps(want, got) <= 1
            else:
                _near(got, want, 1e-5)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------


def test_token_dataset_matches_jax():
    cfg = dict(vocab_size=1000, seq_len=33, global_batch=4, seed=5)
    want = JaxTokenDataset(JaxDataConfig(**cfg))
    got = TokenDataset(DataConfig(**cfg))
    for step in (0, 7):
        for k, v in want.global_batch(step).items():
            np.testing.assert_array_equal(got.global_batch(step)[k], v)
        np.testing.assert_array_equal(got.host_batch(step, 1, 2)["tokens"],
                                      want.host_batch(step, 1, 2)["tokens"])


@pytest.mark.parametrize("shape,classes,seed", [((224, 224, 3), 1000, 0),
                                                 ((8, 8, 16), 10, 3)])
def test_image_dataset_and_device_batch_match_jax(shape, classes, seed):
    """Images and labels bit for bit, and ``device_batch`` keeps values
    and dtypes as the JAX package's does."""
    want = JaxImageDataset(shape, classes, seed)
    got = ImageDataset(shape, classes, seed)
    for step in (0, 4):
        jb, b = want.batch(step, 3), got.batch(step, 3)
        assert sorted(b) == sorted(jb) == ["images", "labels"]
        for k, v in jb.items():
            assert b[k].dtype == v.dtype
            np.testing.assert_array_equal(b[k], v)
        jdev, dev = jax_device_batch(jb), device_batch(b, device="cpu")
        for k, v in jdev.items():
            assert dev[k].device.type == "cpu"
            assert str(dev[k].dtype).removeprefix("torch.") == str(v.dtype)
            np.testing.assert_array_equal(dev[k].numpy(), np.asarray(v))


def _tcfg(cls, acls, path, **kw):
    return cls(ckpt_path=str(path), log_every=1,
               adamw=acls(lr_peak=1e-3, warmup_steps=1, total_steps=3), **kw)


@pytest.mark.parametrize("dtype,route,micro", [
    ("float32", "kernel", 1), ("float32", "blockwise", 2),
    ("bfloat16", "kernel", 2), ("bfloat16", "blockwise", 1)])
def test_trainer_matches_jax(tmp_path, dtype, route, micro):
    """3 steps: loss and grad_norm at every step (LM_REL), and the final
    params (UPDATE_REL)."""
    on = route == "kernel"
    jarch, arch = _archs(dtype)
    data = dict(vocab_size=128, seq_len=32, global_batch=4)
    jtr = JaxTrainer(jarch, _tcfg(JaxTrainConfig, jax_adamw.AdamWConfig,
                                  tmp_path / "j", steps=3, ckpt_every=100,
                                  microbatches=micro),
                     JaxTokenDataset(JaxDataConfig(**data)))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jtr.params),
                                  "cpu")
    params0 = pytree.tree_map(torch.clone, params)
    tr = Trainer(arch, _tcfg(TrainConfig, adamw.AdamWConfig, tmp_path / "t",
                             steps=3, ckpt_every=100, microbatches=micro),
                 TokenDataset(DataConfig(**data)), device="cpu",
                 params=params)
    jax_layers.set_kernel_mode(on, interpret=True)
    layers.set_kernel_mode(on)
    try:
        want = jtr.run()
        got = tr.run()
    finally:
        jax_layers.set_kernel_mode(False)
        layers.set_kernel_mode(True)
    rel = LM_REL[dtype]
    assert [h["step"] for h in got] == [h["step"] for h in want] == [1, 2, 3]
    for h, w in zip(got, want):
        for key in ("loss", "grad_norm"):
            assert abs(h[key] - w[key]) <= rel * abs(w[key]), (key, h, w)
    # final params: each leaf's distance from the JAX package's, over how
    # far training moved it (see UPDATE_REL)
    flat = jax.tree_util.tree_leaves_with_path(jtr.params)
    for path, want_leaf in flat:
        leaf, first = tr.params, params0
        for p in path:
            leaf, first = leaf[p.key], first[p.key]
        want_leaf = np.asarray(want_leaf, np.float64)
        moved = np.linalg.norm(want_leaf - first.double().numpy())
        off = np.linalg.norm(leaf.double().numpy() - want_leaf)
        assert off <= UPDATE_REL[dtype] * moved, (path, off, moved)


def _reduced_trainer(path, steps=8, ckpt_every=3):
    _, arch = _archs("float32")
    tcfg = TrainConfig(steps=steps, ckpt_every=ckpt_every, log_every=1,
                       ckpt_path=str(path),
                       adamw=adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=2,
                                               total_steps=steps))
    data = TokenDataset(DataConfig(vocab_size=arch.vocab_size, seq_len=32,
                                   global_batch=4))
    return Trainer(arch, tcfg, data, device="cpu")


def test_trainer_crash_recovery_bitwise(tmp_path):
    clean = _reduced_trainer(tmp_path / "a")
    clean_hist = clean.run()
    crashed = _reduced_trainer(tmp_path / "b")
    crash_hist = crashed.run(fail_at=5)       # restore from step-3 ckpt
    final_clean = {h["step"]: h["loss"] for h in clean_hist}
    final_crash = {h["step"]: h["loss"] for h in crash_hist}
    for s in final_clean:
        assert final_crash[s] == final_clean[s], s
    assert crashed.step == clean.step == 8
    for a, b in zip(pytree.tree_leaves(clean.params),
                    pytree.tree_leaves(crashed.params)):
        assert torch.equal(a, b)


def test_trainer_restarts_from_initial_weights_without_checkpoint(tmp_path):
    clean = _reduced_trainer(tmp_path / "a", steps=3, ckpt_every=100)
    clean.run()
    crashed = _reduced_trainer(tmp_path / "b", steps=3, ckpt_every=100)
    crashed.run(fail_at=2)
    for a, b in zip(pytree.tree_leaves(clean.params),
                    pytree.tree_leaves(crashed.params)):
        assert torch.equal(a, b)


def test_kernel_error_propagates_out_of_run(tmp_path, monkeypatch):
    """A RuntimeError from inside a step (what a failed build or launch
    raises) leaves Trainer.run at once, with no restore and no retry."""
    tr = _reduced_trainer(tmp_path, steps=3, ckpt_every=1)
    calls = []

    def failing(*a, **kw):
        calls.append(1)
        raise RuntimeError("flash_attention_bwd_dq: CUDA error 700 at "
                           "launch")

    tr.run(n_steps=1)
    monkeypatch.setattr(trainer_mod.tmod, "loss_fn", failing)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tr.run(n_steps=2)
    assert len(calls) == 1 and tr.step == 1


def test_second_failure_of_a_step_is_raised(tmp_path, monkeypatch):
    """One OSError at a step restores and replays it; a second failure of
    the same step is raised."""
    real = trainer_mod.adamw.apply
    now = {"trainer": None, "fails": 0}

    def flaky(*a, **kw):
        if now["trainer"].step == 2 and now["fails"]:
            now["fails"] -= 1
            raise OSError("disk gone")
        return real(*a, **kw)

    monkeypatch.setattr(trainer_mod.adamw, "apply", flaky)
    for fails in (1, 2):
        tr = _reduced_trainer(tmp_path / str(fails), steps=4, ckpt_every=1)
        now.update(trainer=tr, fails=fails)
        if fails == 1:
            tr.run()
            assert tr.step == 4
        else:
            with pytest.raises(OSError, match="disk gone"):
                tr.run()
            assert tr.step == 2


def test_async_checkpoint_is_a_snapshot(tmp_path):
    """An in-place update made right after save() returns does not reach
    the checkpoint; bf16 leaves come back bit for bit."""
    tree = {"params": {"w": torch.randn(64, 64).to(torch.bfloat16),
                       "b": torch.randn(64)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    want = pytree.tree_map(torch.clone, tree)
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(3, tree)
    with torch.no_grad():
        for t in pytree.tree_leaves(tree):
            t.add_(1)
    saver.wait()
    assert ckpt.available_steps(str(tmp_path)) == [3]
    step, got = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 3
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_skips_uncommitted_checkpoint(tmp_path):
    tree = {"x": torch.arange(4.0)}
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 2, {"x": torch.arange(4.0) + 1})
    (tmp_path / "step_00000002" / ckpt.COMMIT).unlink()
    assert ckpt.available_steps(str(tmp_path)) == [1]
    step, got = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 1 and torch.equal(got["x"], tree["x"])
