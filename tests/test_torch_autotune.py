"""The port's autotuner and ``compile(..., autotune=...)`` against the JAX
package's, on the CPU.

The search is host code over copies of the planning modules, so the port
must visit the same candidates in the same order and return the same
record: the tuned and seed candidates, both evaluations, the evaluation
count, the accepted moves, the word scale, the whole objective trace, the
serving credits, every schedule of the tuned plan and the ``summary()``
row (but for the target's name: the JAX package's ``TPU_INTERPRET`` is
the port's ``MINI``, with the same budgets).  This holds for the mini
nets at several seeds and for full ResNet-50 and VGG-16 on ``NX2100``.
A tuned pipeline is then a normal pipeline: the same engine, block and
scan tables and Eq. 2 template as the JAX package's tuned pipeline, its
report verified, and its CPU ``run()`` bit-identical to the JAX
package's plain ``cnn_forward``.  The rest pins the surface: ``serve()``
defaults to the tuned credits, ``with_offload`` drops ``tuning``, bad
configs and an infeasible target raise as in the JAX package.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jc
from repro.compiler import autotune as jat
from repro.configs import cnn as jcfg
from repro.models.cnn import cnn_forward as jax_cnn_forward
from repro_torch import compiler as tc
from repro_torch.compiler import autotune as tat
from repro_torch.configs import cnn as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.core import admission as tadm
from repro_torch.models.cnn import cnn_input_shape
from repro_torch.obs.metrics import default_registry
from torch_testdata import numpy_cnn_params

MINI_NETS = ("mini_resnet18", "mini_resnet50")
# seed 0 at 150 iterations, and seeds 0-3 at 60
SEARCHES = ((0, 150), (0, 60), (1, 60), (2, 60), (3, 60))
FULL_NETS = ("resnet50", "vgg16")
FULL_ITERATIONS = 40
# compile(..., autotune=...) runs its own search in each package
COMPILE_AT = dict(seed=0, iterations=60)
PKG = {"jax": (jc, jcfg, jc.TPU_INTERPRET, jc.NX2100),
       "torch": (tc, tcfg, tc.MINI, tc.NX2100)}


def _cfg(cfgmod, name):
    if name.startswith("mini_"):
        return getattr(cfgmod, name)(hw=8, width=16, stages=4)
    return cfgmod.get_cnn(name)


def _target(pkg, name):
    _, _, mini, nx = PKG[pkg]
    return mini if name.startswith("mini_") else nx


@functools.lru_cache(None)
def _search(pkg, name, seed, iterations):
    comp, cfgmod = PKG[pkg][:2]
    return comp.autotune_plan(
        _cfg(cfgmod, name), _target(pkg, name),
        comp.AutotuneConfig(seed=seed, iterations=iterations))


@functools.lru_cache(None)
def _compiled(pkg, name):
    comp, cfgmod = PKG[pkg][:2]
    return comp.compile(_cfg(cfgmod, name), _target(pkg, name),
                        autotune=comp.AutotuneConfig(**COMPILE_AT))


def _record(r):
    """Everything an ``AutotuneResult`` says, as plain values, but the
    target's name."""
    summary = r.summary()
    summary.pop("target")
    asd = dataclasses.asdict
    return {
        "cfg_name": r.cfg_name, "search": asd(r.search),
        "candidate": asd(r.candidate),
        "seed_candidate": asd(r.seed_candidate),
        "tuned": asd(r.tuned), "greedy": asd(r.greedy),
        "serving_credits": r.serving_credits,
        "evaluations": r.evaluations, "accepted_moves": r.accepted_moves,
        "word_scale": r.word_scale, "objective_trace": r.objective_trace,
        "improved": r.improved, "summary": summary,
        "schedules": [asd(s) for s in r.plan.schedules],
        "plan": (r.plan.burst, r.plan.n_pc, r.plan.streamed_names),
    }


def _assert_same_search(name, seed, iterations):
    got = _record(_search("torch", name, seed, iterations))
    want = _record(_search("jax", name, seed, iterations))
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("seed,iterations", SEARCHES)
@pytest.mark.parametrize("name", MINI_NETS)
def test_mini_search_equals_jax(name, seed, iterations):
    _assert_same_search(name, seed, iterations)


@pytest.mark.parametrize("name", FULL_NETS)
def test_full_net_search_equals_jax(name):
    _assert_same_search(name, 0, FULL_ITERATIONS)
    r = _search("torch", name, 0, FULL_ITERATIONS)
    assert r.summary()["target"] == "nx2100"
    assert r.improved and r.tuned.images_per_s >= r.greedy.images_per_s


@pytest.mark.parametrize("name", MINI_NETS)
def test_tuned_plan_beats_greedy_on_port_fifo_sim(name):
    """The tuned stall count is the port's fifo_sim verdict on the tuned
    plan, strictly below the greedy seed's, at equal throughput."""
    r = _search("torch", name, 0, 150)
    out = r.plan.predict_stalls(r.search.outputs_needed,
                                word_scale=r.word_scale)
    assert out.completed and not out.deadlocked
    assert out.stall_cycles == r.tuned.stall_cycles < r.greedy.stall_cycles
    assert r.tuned.objective <= r.greedy.objective
    assert r.tuned.images_per_s >= r.greedy.images_per_s


@pytest.mark.parametrize("latency", range(9))
def test_solve_serving_credits_equals_jax(latency):
    c = tat.solve_serving_credits(latency, items=32, max_credits=12)
    assert c == jat.solve_serving_credits(latency, items=32,
                                          max_credits=12)
    assert tat.solve_serving_credits(latency) == \
        jat.solve_serving_credits(latency)
    saturated = tadm.replay_schedule(32, capacity=12,
                                     latency_ticks=latency).makespan
    assert tadm.replay_schedule(32, capacity=c,
                                latency_ticks=latency).makespan == saturated
    if c > 1:
        assert tadm.replay_schedule(
            32, capacity=c - 1, latency_ticks=latency).makespan > saturated


@pytest.mark.parametrize("name", MINI_NETS)
def test_tuned_compile_tables_equal_jax(name):
    j, t = _compiled("jax", name), _compiled("torch", name)
    assert _record(t.tuning) == _record(j.tuning) == _record(
        _search("jax", name, **COMPILE_AT))
    assert t.replaced == j.replaced == ()
    assert t.engine_table() == j.engine_table()
    assert t.block_table() == j.block_table()
    assert t.scan_table() == j.scan_table()
    assert [dataclasses.asdict(g) for g in t.scan_assignments] == \
        [dataclasses.asdict(g) for g in j.scan_assignments]
    assert t.vmem_report() == j.vmem_report()
    tr, jr = t.eq2_report(8), j.eq2_report(8)
    assert [dataclasses.asdict(x) for x in tr.layers] == \
        [dataclasses.asdict(x) for x in jr.layers]
    assert tr.hbm_weight_words == jr.hbm_weight_words
    tr.verify()
    assert t.throughput() == j.throughput()


@pytest.mark.parametrize("backend", ["fused", "eager"])
@pytest.mark.parametrize("name", MINI_NETS)
def test_tuned_run_bit_identical_to_jax_forward(name, backend):
    cp = _compiled("torch", name)
    params = numpy_cnn_params(cp.cfg, seed=3)
    rng = np.random.default_rng(4)
    x = rng.integers(-127, 128, size=cnn_input_shape(cp.cfg, 2),
                     dtype=np.int8)
    got, rep = cp.run(params_from_numpy(params, "cpu"), torch.from_numpy(x),
                      device="cpu", backend=backend)
    jcfg_ = _cfg(jcfg, name)
    want = jax.jit(lambda p, x: jax_cnn_forward(p, jcfg_, x))(
        params, jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rep.verify()
    assert rep.total_hbm_words == \
        2 * sum(cp.plan.hbm_words_per_image().values())


def test_serve_defaults_to_tuned_credits():
    """A search whose dispatch depth gives 2 credits, so the default is
    told apart from the untuned 4; an explicit ``credits`` wins."""
    cfg = _cfg(tcfg, "mini_resnet18")
    cp = tc.compile(cfg, tc.MINI, autotune=tc.AutotuneConfig(
        iterations=0, serving_latency_ticks=1))
    assert cp.tuning.serving_credits == \
        jat.solve_serving_credits(1) == 2
    params = params_from_numpy(numpy_cnn_params(cfg, 0), "cpu")
    assert cp.serve(params, device="cpu").admission.capacity == 2
    assert cp.serve(params, device="cpu",
                    credits=7).admission.capacity == 7
    plain = tc.compile(cfg, tc.MINI)
    assert plain.serve(params, device="cpu").admission.capacity == 4


def test_compile_without_autotune_and_with_offload_drop_tuning():
    cfg = _cfg(tcfg, "mini_resnet18")
    plain = tc.compile(cfg, tc.MINI)
    assert plain.tuning is None
    assert tc.compile(cfg, tc.MINI, autotune=False).tuning is None
    cp = _compiled("torch", "mini_resnet18")
    assert cp.tuning is not None and cp.tuning.improved
    forced = cp.with_offload(cp.streamed_names)
    assert forced.tuning is None
    assert forced.engine_table() == cp.engine_table()
    assert forced.trace_cache_size == cp.trace_cache_size


def test_autotune_true_is_the_default_config():
    """``autotune=True`` runs ``AutotuneConfig()``; the pass is timed
    under ``compile_pass_seconds{pass=autotune}``."""
    hist = default_registry().histogram("compile_pass_seconds",
                                        **{"pass": "autotune"})
    before = hist.count
    cfg = tcfg.mini_resnet50(hw=8, width=16, stages=2)
    cp = tc.compile(cfg, tc.MINI, autotune=True)
    assert cp.tuning.search == tc.AutotuneConfig()
    assert hist.count == before + 1
    cp.eq2_report(2).verify()


def test_zero_iterations_returns_the_seed():
    r = tc.autotune_plan(_cfg(tcfg, "mini_resnet18"), tc.MINI,
                         tc.AutotuneConfig(iterations=0))
    assert r.candidate == r.seed_candidate and r.tuned == r.greedy
    assert r.objective_trace == ((0, r.greedy.objective,
                                  r.greedy.objective),)


@pytest.mark.parametrize("kw", [dict(strategy="magic"),
                                dict(iterations=-1)])
def test_bad_config_rejected_as_in_jax(kw):
    with pytest.raises(ValueError) as got:
        tc.AutotuneConfig(**kw)
    with pytest.raises(ValueError) as want:
        jc.AutotuneConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("change,fault", [
    ("offload", "unstreamable"), ("burst", "uncharacterized burst"),
    ("bm_words", "bm_words"), ("laststage", "latency-covering minimum")])
def test_cost_model_rejects_bad_candidates_as_in_jax(change, fault):
    evs = []
    for mod, cfgmod, target in ((tat, tcfg, tc.MINI),
                                (jat, jcfg, jc.TPU_INTERPRET)):
        model = mod._CostModel(_cfg(cfgmod, "mini_resnet18"), target,
                               mod.AutotuneConfig())
        seed = model.seed_candidate
        bad = {"offload": seed.offload + ("gap",), "burst": 5,
               "bm_words": seed.burst - 1,
               "laststage": seed.laststage // 2}[change]
        evs.append(model.evaluate(dataclasses.replace(seed,
                                                      **{change: bad})))
    got, want = evs
    assert not got.feasible
    assert any(fault in v for v in got.violations)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_infeasible_target_raises_as_in_jax():
    with pytest.raises(tc.AutotuneError) as got:
        tc.autotune_plan(_cfg(tcfg, "mini_resnet18"),
                         tc.MINI.replace(vmem_bytes=1),
                         tc.AutotuneConfig(iterations=5))
    with pytest.raises(jc.AutotuneError) as want:
        jc.autotune_plan(_cfg(jcfg, "mini_resnet18"),
                         jc.TPU_INTERPRET.replace(vmem_bytes=1),
                         jc.AutotuneConfig(iterations=5))
    assert isinstance(got.value, ValueError)
    # the same violations; only the targets' names differ
    assert str(got.value).split("infeasible: ")[1] == \
        str(want.value).split("infeasible: ")[1]
    with pytest.raises(tc.AutotuneError):
        tc.compile(_cfg(tcfg, "mini_resnet18"),
                   tc.MINI.replace(vmem_bytes=1), autotune=True)
