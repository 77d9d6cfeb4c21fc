"""The port's partition pass against the JAX package's, on the CPU.

``partition_pipeline`` is a compile pass (host-only), so it is held to
the JAX package's at every net the repo runs: the mini nets on ``MINI``
(the JAX package's ``TPU_INTERPRET``), ResNet-18, ResNet-50, VGG-16 and
MobileNetV2 on ``NX2100``, and two autotuned nets: mini ResNet-50 at
``AutotuneConfig(iterations=60)`` (whose search keeps the greedy plan)
and ResNet-50 at 20 iterations (one scan group where greedy has three,
so the cuts meet other atomic units), for S = 1..6.  Every
``StageProgram``, the balance, ``describe()``, each boundary shape, the
modelled throughput and each stage's Eq. 2 report rows must be equal;
``PartitionError`` is raised in the same cases with the same message.
The stage walks (``stage_forward_fns``) composed must equal the port's
``run(device="cpu")`` and the JAX package's jitted plain ``cnn_forward``
bit for bit.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jc
from repro.compiler import partition as jpart
from repro.configs import cnn as jcfg
from repro.models.cnn import cnn_forward as jax_cnn_forward
from repro_torch import compiler as tc
from repro_torch.compiler import partition as tpart
from repro_torch.compiler.pipeline import trace_fused
from repro_torch.configs import cnn as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.models.cnn import cnn_input_shape
from torch_testdata import numpy_cnn_params

MINI_KW = {"mini_resnet18": dict(hw=8, width=16, stages=4),
           "mini_resnet50": dict(hw=8, width=16, stages=4),
           "mini_mobilenet": dict(hw=8, width=16, blocks=4)}
FULL = ("resnet18", "resnet50", "vgg16", "mobilenetv2")
# autotuned nets and the search's iterations
TUNED = {"mini_resnet50_tuned": 60, "resnet50_tuned": 20}
NETS = tuple(MINI_KW) + FULL + tuple(TUNED)
STAGES = range(1, 7)
MB = 2


def _cfgs(name):
    base = name[:-len("_tuned")] if name.endswith("_tuned") else name
    if base in MINI_KW:
        return (getattr(jcfg, base)(**MINI_KW[base]),
                getattr(tcfg, base)(**MINI_KW[base]))
    return jcfg.get_cnn(base), tcfg.get_cnn(base)


_COMPILED = {}


def _compiled(name):
    """(JAX pipeline, port pipeline) for a net, compiled once a module."""
    if name not in _COMPILED:
        jcfg_, tcfg_ = _cfgs(name)
        jt, tt = ((jc.TPU_INTERPRET, tc.MINI) if name.startswith("mini_")
                  else (jc.NX2100, tc.NX2100))
        jkw = tkw = {}
        if name in TUNED:
            jkw = {"autotune": jc.AutotuneConfig(iterations=TUNED[name])}
            tkw = {"autotune": tc.AutotuneConfig(iterations=TUNED[name])}
        _COMPILED[name] = (jc.compile(jcfg_, jt, **jkw),
                           tc.compile(tcfg_, tt, **tkw))
    return _COMPILED[name]


def _rows(rep):
    return ([dataclasses.astuple(s) for s in rep.layers], rep.block_rows(),
            rep.scan_rows(), rep.images,
            [s.spec.name for s in rep.plan.schedules])


def test_tuned_scans_differ_from_greedy():
    """Tuned ResNet-50's scan groups are not the greedy plan's, so its
    cuts meet other atomic units."""
    _, greedy = _compiled("resnet50")
    _, tuned = _compiled("resnet50_tuned")
    assert tuned.tuning is not None
    assert tuned.scan_table() != greedy.scan_table()
    assert tpart._atomic_units(tuned) != tpart._atomic_units(greedy)


@pytest.mark.parametrize("name", NETS)
def test_atomic_units_match_jax(name):
    jcp, tcp = _compiled(name)
    assert tpart._atomic_units(tcp) == jpart._atomic_units(jcp)


@pytest.mark.parametrize("S", STAGES)
@pytest.mark.parametrize("name", NETS)
def test_partition_matches_jax(name, S):
    jcp, tcp = _compiled(name)
    assert len(tpart._atomic_units(tcp)) >= S
    jp, tp = jcp.partition(S), tcp.partition(S)
    assert [dataclasses.astuple(s) for s in tp.stages] == \
        [dataclasses.astuple(s) for s in jp.stages]
    assert (tp.n_stages, tp.total_cycles, tp.max_stage_cycles) == \
        (jp.n_stages, jp.total_cycles, jp.max_stage_cycles)
    assert tp.balance == jp.balance
    assert tp.describe() == jp.describe()
    for s in range(S):
        assert tp.boundary_shape(s, MB) == jp.boundary_shape(s, MB)
        assert _rows(tp.stage_report(s, MB)) == _rows(jp.stage_report(s, MB))
    assert tp.out_shape(MB) == jp.out_shape(MB)
    for M in (1, 8 * S, 32):
        assert tp.modelled_throughput(M) == jp.modelled_throughput(M)
    t_reps, j_reps = tp.verify_eq2(batch=MB), jp.verify_eq2(batch=MB)
    assert [_rows(r) for r in t_reps] == [_rows(r) for r in j_reps]
    assert sum(sp.hbm_words_per_image for sp in tp.stages) == \
        sum(tcp.plan.hbm_words_per_image().values())


@pytest.mark.parametrize("name", NETS)
def test_partition_errors_match_jax(name):
    jcp, tcp = _compiled(name)
    units = len(tpart._atomic_units(tcp))
    for n in (0, -1, units + 1):
        with pytest.raises(jpart.PartitionError) as jerr:
            jcp.partition(n)
        with pytest.raises(tc.PartitionError) as terr:
            tcp.partition(n)
        assert str(terr.value) == str(jerr.value)
    assert isinstance(terr.value, ValueError)
    assert tc.partition_pipeline(tcp, units).n_stages == units


def test_verify_eq2_rejects_stages_that_do_not_tile():
    _, tcp = _compiled("mini_resnet18")
    part = tcp.partition(2)
    gap = dataclasses.replace(part.stages[1],
                              layer_range=(part.stages[1].layer_range[0] + 1,
                                           part.stages[1].layer_range[1]))
    with pytest.raises(tc.PartitionError, match="tile"):
        dataclasses.replace(part, stages=(part.stages[0], gap)).verify_eq2()
    short = dataclasses.replace(part, stages=part.stages[:1])
    with pytest.raises(tc.PartitionError, match="cover"):
        short.verify_eq2()


@pytest.mark.parametrize("seed", range(8))
def test_linear_partition_matches_jax_and_is_optimal(seed):
    """The DP's cuts equal the JAX package's, and its max-stage cost
    equals brute force over every contiguous cut."""
    rng = np.random.default_rng(seed)
    for _ in range(4):
        n = int(rng.integers(2, 9))
        k = int(rng.integers(1, n + 1))
        costs = [int(c) for c in rng.integers(1, 100, size=n)]
        cuts = tpart._linear_partition(costs, k)
        assert cuts == jpart._linear_partition(costs, k)
        got = max(sum(costs[a:b]) for a, b in cuts)
        best = min(
            max(sum(costs[a:b]) for a, b in
                zip((0,) + combo, combo + (n,)))
            for combo in itertools.combinations(range(1, n), k - 1))
        assert got == best, (costs, k, cuts)


_REFS = {}


def _images_and_refs(name):
    """Seeded images and params, the port's ``run(device="cpu")`` and the
    JAX package's jitted plain ``cnn_forward`` on them."""
    if name not in _REFS:
        jcp, tcp = _compiled(name)
        cfg = tcp.cfg
        np_params = numpy_cnn_params(cfg, seed=1)
        rng = np.random.default_rng(2)
        x = rng.integers(-127, 128, size=cnn_input_shape(cfg, MB),
                         dtype=np.int8)
        params = params_from_numpy(np_params, "cpu")
        run, _ = tcp.run(params, torch.from_numpy(x), device="cpu")
        jfwd = jax.jit(lambda p, v: jax_cnn_forward(p, jcp.cfg, v))
        want = np.asarray(jfwd(np_params, jnp.asarray(x)))
        _REFS[name] = (x, params, run.numpy(), want)
    return _REFS[name]


@pytest.mark.parametrize("S", (1, 2, 4))
@pytest.mark.parametrize("name", tuple(MINI_KW) + ("mini_resnet50_tuned",))
def test_stage_walks_compose_bit_identical(name, S):
    """Chaining the stage walks reproduces ``run()`` and the JAX plain
    forward bit for bit; each walk's collected stats are its stage's Eq. 2
    template, and ``trace_fused(..., layer_range=)`` gives the same stage
    output and stats."""
    _, tcp = _compiled(name)
    x, params, run, want = _images_and_refs(name)
    np.testing.assert_array_equal(run, want)
    part = tcp.partition(S)
    collect = [[] for _ in range(S)]
    fns = tpart.stage_forward_fns(part, collect=collect)
    y = torch.from_numpy(x)
    for s, fn in enumerate(fns):
        assert tuple(y.shape) == part.boundary_shape(s, MB)
        trace, first = trace_fused(tcp, params, y, act_scale=0.05,
                                   layer_range=part.stages[s].layer_range)
        y = fn(params, y)
        assert torch.equal(first, y)
        assert [dataclasses.astuple(st) for st in collect[s]] == \
            [dataclasses.astuple(st) for st in trace.stats] == \
            [dataclasses.astuple(st)
             for st in part.stage_report(s, MB).layers]
        if s < S - 1:
            assert y.dtype == torch.int8
    assert tuple(y.shape) == part.out_shape(MB)
    np.testing.assert_array_equal(y.numpy(), want)
    assert tcp.trace_count == 1         # the run() above, nothing else
