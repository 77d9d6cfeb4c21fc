"""The port's stage-6 fused backend against the JAX package's, on the CPU.

On the CPU the port's "trace" is the eager walk (the card captures a CUDA
graph, tests/test_torch_cuda.py); what must match the JAX package here is
everything around it: ``run()`` defaulting to the fused backend, logits
and per-layer reports bit-identical to JAX ``run(backend="fused")``, and
the bounded-LRU trace cache's counters after the same sequence of batch
sizes (``trace_cache_size=2``: hits, misses, evictions, entries).
"""
import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jc
from repro.configs import cnn as jcfg
from repro_torch import compiler as tc
from repro_torch.compiler.pipeline import FusedTrace
from repro_torch.configs import cnn as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.models.cnn import cnn_forward, cnn_input_shape
from repro_torch.runtime.pipeline import PipelineExecutor

JMINI = jcfg.mini_resnet18(hw=16, width=32)
MINI = tcfg.mini_resnet18(hw=16, width=32)
# batch sizes through a 2-entry cache: miss, miss, hit, miss + eviction,
# hit; three distinct shapes, so the JAX side compiles three programs
SEQUENCE = (2, 1, 2, 3, 2)


def _numpy_params(cfg, seed):
    """Seeded int8 weights, per-channel scales and biases for every
    weighted node, as numpy arrays: what both packages are given."""
    rng = np.random.default_rng(seed)
    out = {}
    for spec in cfg.layers:
        if spec.is_pool:
            continue
        dw = spec.kind == "dwconv"
        c_out = spec.c_in if dw else spec.c_out
        shape = (spec.k_h, spec.k_w, 1 if dw else spec.c_in, c_out)
        out[spec.name] = {
            "w": rng.integers(-127, 128, size=shape, dtype=np.int8),
            "w_scale": rng.uniform(0.01, 0.06, c_out).astype(np.float32),
            "bias": rng.normal(0.0, 0.5, c_out).astype(np.float32)}
    return out


def _rows(result):
    return [dataclasses.astuple(s) for s in result.layers]


@pytest.fixture(scope="module")
def both():
    """The same seeded images and params through both packages'
    fused ``run()`` at each batch size of SEQUENCE, with each package's
    trace-cache counters read after every step."""
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, size=cnn_input_shape(MINI, max(SEQUENCE)),
                     dtype=np.int8)
    params = _numpy_params(MINI, seed=0)
    jcp = jc.compile(JMINI, jc.TPU_INTERPRET, trace_cache_size=2)
    tcp = tc.compile(MINI, tc.MINI, trace_cache_size=2)
    tparams = params_from_numpy(params, "cpu")
    steps = []
    for b in SEQUENCE:
        want, jrep = jcp.run(params, jnp.asarray(x[:b]), backend="fused")
        got, rep = tcp.run(tparams, torch.from_numpy(x[:b]), device="cpu")
        steps.append(dict(batch=b, want=np.asarray(want), jrep=jrep,
                          got=got, rep=rep,
                          jstats=jcp.trace_cache_stats(),
                          stats=tcp.trace_cache_stats(),
                          jcount=jcp.trace_count, count=tcp.trace_count))
    return dict(steps=steps, x=x, params=tparams, tcp=tcp)


@pytest.mark.parametrize("step", range(len(SEQUENCE)))
def test_fused_logits_and_reports_bit_identical_to_jax(both, step):
    s = both["steps"][step]
    assert s["got"].dtype == torch.float32
    np.testing.assert_array_equal(s["got"].numpy(), s["want"])
    assert _rows(s["rep"]) == _rows(s["jrep"])
    assert s["rep"].hbm_weight_words == s["jrep"].hbm_weight_words
    assert s["rep"].total_hbm_words == s["jrep"].total_hbm_words > 0
    s["rep"].verify()


@pytest.mark.parametrize("step", range(len(SEQUENCE)))
def test_trace_cache_counters_match_jax(both, step):
    s = both["steps"][step]
    assert s["stats"] == s["jstats"]
    assert s["count"] == s["jcount"]


def test_trace_cache_sequence_evicts(both):
    """The sequence exercises every counter: 3 misses, 2 hits, and the
    batch-1 trace evicted when batch 3 arrived."""
    last = both["steps"][-1]["stats"]
    assert last == {"entries": 2, "max_entries": 2, "hits": 2,
                    "misses": 3, "evictions": 1}


@pytest.fixture(scope="module")
def port():
    rng = np.random.default_rng(1)
    params = params_from_numpy(_numpy_params(MINI, seed=1), "cpu")
    x = torch.from_numpy(rng.integers(
        -127, 128, size=cnn_input_shape(MINI, 2), dtype=np.int8))
    return tc.compile(MINI, tc.MINI), params, x


def test_fused_is_the_default_and_bit_identical_to_eager(port):
    cp, params, x = port
    assert cp.block_assignments and cp.streamed_names
    fused, rf = cp.run(params, x, device="cpu")
    eager, re_ = cp.run(params, x, device="cpu", backend="eager")
    assert PipelineExecutor(cp, device="cpu").backend == "fused"
    assert torch.equal(fused, eager)
    assert torch.equal(fused, cnn_forward(params, MINI, x))
    assert rf.layers == re_.layers
    assert rf.total_hbm_words == re_.total_hbm_words > 0


def test_fused_trace_cache_one_retrace_per_shape(port):
    cp0, params, x = port
    cp = tc.compile(MINI, tc.MINI)                 # fresh, empty cache
    assert cp.trace_count == 0
    ex = PipelineExecutor(cp, device="cpu")
    ex.run(params, x)
    assert cp.trace_count == 1
    ex.run(params, x)
    ex.run(params, x)
    assert cp.trace_count == 1
    ex.run(params, x[:1])
    assert cp.trace_count == 2
    PipelineExecutor(cp, device="cpu").run(params, x)
    assert cp.trace_count == 2
    assert cp.trace_cache_stats()["hits"] == 3


def test_fused_reports_scale_with_batch(port):
    cp, params, x = port
    per_image = sum(cp.plan.hbm_words_per_image().values())
    _, r2 = cp.run(params, x, device="cpu")
    _, r1 = cp.run(params, x[:1], device="cpu")
    assert r2.total_hbm_words == 2 * per_image
    assert r1.total_hbm_words == per_image


def test_fused_trace_stats_are_the_template(port):
    cp, params, x = port
    trace = cp.fused_trace(params, x, act_scale=0.05)
    assert isinstance(trace, FusedTrace)
    assert trace.stats == cp.stats_template(batch=2)
    assert torch.equal(trace.fn(params, x), cnn_forward(params, MINI, x))


def test_concurrent_runs_do_not_cross_reports(port):
    cp, params, x = port
    per_image = sum(cp.plan.hbm_words_per_image().values())
    ex = PipelineExecutor(cp, device="cpu")
    results = {}

    def worker(name, images):
        results[name] = ex.run(params, images)

    threads = [threading.Thread(target=worker, args=(f"b{b}-{i}", x[:b]))
               for b in (1, 2) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    ref = cnn_forward(params, MINI, x)
    for name, (logits, report) in results.items():
        batch = int(name[1])
        assert report.images == batch
        assert report.total_hbm_words == batch * per_image
        assert torch.equal(logits, ref[:batch])


def test_block_granular_eq2_rows_on_both_backends(port):
    cp, params, x = port
    for backend in ("fused", "eager"):
        _, rep = cp.run(params, x, device="cpu", backend=backend)
        for row in rep.block_rows():
            b = cp.block_for(row["block"])
            assert row["hbm_words"] == 2 * b.hbm_words_per_image
        rep.verify()
    assert any(b.hbm_words_per_image for b in cp.block_assignments)


def test_first_cpu_run_walks_the_net_once(port):
    """On the CPU the trace is the eager walk; the run that makes it uses
    its logits instead of walking a second time, and warm runs walk once
    each."""
    cp0, params, x = port
    calls = []
    builtin = tc.get_engine("stream_matmul")

    @tc.register_engine("fc_probe", priority=99)
    class ProbeFCEngine:
        def supports(self, spec):
            return builtin.supports(spec)

        def vmem_bytes(self, spec, sched):
            return builtin.vmem_bytes(spec, sched)

        def stats(self, sched, batch):
            return builtin.stats(sched, batch)

        def run(self, ctx, sched, p, xx, relu):
            calls.append(sched.spec.name)
            return builtin.run(ctx, sched, p, xx, relu)

    try:
        probed = tc.compile(MINI, tc.MINI)
        assert probed.engine_table()["fc"] == "fc_probe"
        first, _ = probed.run(params, x, device="cpu")
        assert calls == ["fc"]
        second, _ = probed.run(params, x, device="cpu")
        assert calls == ["fc", "fc"]
        assert torch.equal(first, second)
    finally:
        assert tc.unregister_engine("fc_probe") is not None


def test_trace_cache_size_is_carried_and_validated():
    cp = tc.compile(MINI, tc.MINI, trace_cache_size=3)
    assert cp.trace_cache_stats()["max_entries"] == 3
    forced = cp.with_offload(cp.streamed_names)
    assert forced.trace_cache_size == 3
    with pytest.raises(ValueError, match="trace cache"):
        tc.compile(MINI, tc.MINI, trace_cache_size=0)


def test_unknown_backend_rejected(port):
    cp, _, _ = port
    with pytest.raises(ValueError, match="backend"):
        PipelineExecutor(cp, device="cpu", backend="rtl")
