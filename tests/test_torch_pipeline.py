"""The port's slice end to end on the CPU: ``compile(cfg, target).run``
with JAX-initialised parameters carried across gives logits bit-identical
to the JAX package's pipeline and to its functional reference, with the
same per-layer Eq. 2 words."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jc
from repro.configs import cnn as jcfg
from repro.models.cnn import cnn_forward as jax_cnn_forward
from repro.models.cnn import init_cnn_params as jax_init
from repro_torch import compiler as tc
from repro_torch.configs import cnn as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.models.cnn import cnn_forward, cnn_input_shape


def _inputs(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, size=cnn_input_shape(cfg, batch),
                     dtype=np.int8)
    params = jax.tree_util.tree_map(
        np.asarray, jax_init(jax.random.PRNGKey(seed), cfg))
    return params, x


@pytest.mark.parametrize("name", ["mini_resnet18", "mini_resnet50"])
def test_mini_net_bit_identical_to_jax(name):
    jcfg_, tcfg_ = getattr(jcfg, name)(), getattr(tcfg, name)()
    params, x = _inputs(jcfg_, 2, seed=0)
    jcomp = jc.compile(jcfg_, jc.TPU_INTERPRET)
    want, jrep = jcomp.run(params, jnp.asarray(x))
    want_fn = jax_cnn_forward(params, jcfg_, jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(want_fn))

    tcomp = tc.compile(tcfg_, tc.MINI)
    got, rep = tcomp.run(params_from_numpy(params, "cpu"),
                         torch.from_numpy(x), device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rep.hbm_weight_words == jrep.hbm_weight_words
    if name == "mini_resnet18":               # Algorithm 1 streams 7 layers
        assert len(rep.hbm_weight_words) == 7
    assert rep.engines_used() == jrep.engines_used()
    rep.verify()
    tcomp.eq2_report(batch=2).verify()
    # the plain functional path agrees too
    ref = cnn_forward(params_from_numpy(params, "cpu"), tcfg_,
                      torch.from_numpy(x))
    assert torch.equal(ref, got)


def test_full_width_resnet18_bit_identical_to_jax():
    jcfg_, tcfg_ = jcfg.get_cnn("resnet18"), tcfg.get_cnn("resnet18")
    params, x = _inputs(jcfg_, 1, seed=1)
    want = jax_cnn_forward(params, jcfg_, jnp.asarray(x))
    got, rep = tc.compile(tcfg_, tc.NX2100).run(
        params_from_numpy(params, "cpu"), torch.from_numpy(x), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (1, 1000)
    rep.verify()


def test_offloaded_stem_and_fc_run_streamed_tiers():
    """Forcing the stem conv and the fc head onto the HBM tier drives the
    streamed conv and the fifo matmul paths; logits stay identical."""
    cfg = tcfg.mini_resnet18()
    params, x = _inputs(jcfg.mini_resnet18(), 2, seed=2)
    comp = tc.compile(cfg, tc.MINI)
    forced = comp.with_offload(set(comp.streamed_names) | {"stem", "fc"})
    p, xt = params_from_numpy(params, "cpu"), torch.from_numpy(x)
    base, _ = comp.with_offload([]).run(p, xt, device="cpu")
    got, rep = forced.run(p, xt, device="cpu")
    assert torch.equal(got, base)
    assert rep.hbm_weight_words["stem"] > 0 and rep.hbm_weight_words["fc"] > 0
    rep.verify()


def _dw_names(cfg):
    return {layer.name for layer in cfg.layers if layer.kind == "dwconv"}


@pytest.mark.parametrize("forced", [False, True],
                         ids=["compiled", "dw_on_hbm"])
def test_mini_mobilenet_bit_identical_to_jax(forced):
    """``mini_mobilenet`` through ``dwconv_int8``: as compiled (every dw
    layer pinned) and with every dw layer forced onto the HBM tier, which
    puts the JAX package's streamed depthwise Pallas kernel on its
    path."""
    jcfg_ = jcfg.mini_mobilenet(hw=8, width=16, blocks=4)
    tcfg_ = tcfg.mini_mobilenet(hw=8, width=16, blocks=4)
    params, x = _inputs(jcfg_, 2, seed=3)
    jcomp = jc.compile(jcfg_, jc.TPU_INTERPRET)
    tcomp = tc.compile(tcfg_, tc.MINI)
    if forced:
        dw = _dw_names(tcfg_)
        jcomp = jcomp.with_offload(set(jcomp.streamed_names) | dw)
        tcomp = tcomp.with_offload(set(tcomp.streamed_names) | dw)
    want, jrep = jcomp.run(params, jnp.asarray(x))
    got, rep = tcomp.run(params_from_numpy(params, "cpu"),
                         torch.from_numpy(x), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    engines = rep.engines_used()
    assert {engines[n] for n in _dw_names(tcfg_)} == {"dwconv_int8"}
    assert engines == jrep.engines_used()
    assert rep.hbm_weight_words == jrep.hbm_weight_words
    if forced:
        assert set(rep.hbm_weight_words) >= _dw_names(tcfg_)
    rep.verify()
    tcomp.eq2_report(batch=2).verify()


def test_full_width_mobilenetv2_bit_identical_to_jax():
    jcfg_, tcfg_ = jcfg.get_cnn("mobilenetv2"), tcfg.get_cnn("mobilenetv2")
    params, x = _inputs(jcfg_, 1, seed=4)
    want = jax_cnn_forward(params, jcfg_, jnp.asarray(x))
    got, rep = tc.compile(tcfg_, tc.NX2100).run(
        params_from_numpy(params, "cpu"), torch.from_numpy(x), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (1, 1000)
    engines = rep.engines_used()
    assert {engines[n] for n in _dw_names(tcfg_)} == {"dwconv_int8"}
    assert len(_dw_names(tcfg_)) == 17
    rep.verify()
