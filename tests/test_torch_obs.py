"""The port's observability copies against the JAX package's ``obs``.

``repro_torch.obs`` keeps its own copies of the framework-free
``trace.py``, ``stall.py`` and ``metrics.py``; the same operations under
the same :class:`ManualClock` must give the same Chrome trace, the same
metrics snapshot, and the same ``stall_attribution`` section on the same
``fifo_sim`` outcome.  A traced serving interval of the port (CPU)
exports a valid trace, and ``compile()``/``run()`` record their pass
timings and trace-cache gauges into the default registry.
"""
import numpy as np
import pytest
import torch

from repro import compiler as jc
from repro import obs as jobs
from repro.configs import cnn as jcfg
from repro.core import fifo_sim as jfifo
from repro_torch import compiler as tc
from repro_torch import obs
from repro_torch.configs import cnn as tcfg
from repro_torch.core import fifo_sim
from repro_torch.models.cnn import cnn_input_shape, init_cnn_params

SERVING_TRACKS = ("request", "admission", "pack", "dispatch",
                  "in_flight", "delivery")


def _drive_tracer(mod, capacity):
    """One scripted timeline through a tracer of package ``mod``."""
    clk = mod.ManualClock(start=5.0, step=0.001)
    tr = mod.Tracer(clock=clk, capacity=capacity)
    tr.begin("request", "request", 1, images=3)
    with tr.span("credit_wait", "admission"):
        clk.advance(0.01)
    with tr.span("pack", "pack"):
        pass
    with tr.span("dispatch", "dispatch", filled=3, shape_rows=4):
        clk.advance(0.002)
    tr.begin("microbatch", "in_flight", 1, filled=3)
    tr.counter("queue_depth", 2)
    tr.instant("evict", "dispatch", entries=1)
    tr.end("microbatch", "in_flight", 1)
    with tr.span("deliver", "delivery", seq=1):
        pass
    tr.end("request", "request", 1)
    return tr


@pytest.mark.parametrize("capacity", [65536, 6])
def test_chrome_trace_matches_reference(capacity):
    mine, theirs = _drive_tracer(obs, capacity), _drive_tracer(jobs, capacity)
    assert mine.events() == theirs.events()
    assert mine.stats() == theirs.stats()
    assert mine.to_chrome_trace() == theirs.to_chrome_trace()
    assert obs.validate_chrome_trace(mine.to_chrome_trace()) == \
        jobs.validate_chrome_trace(theirs.to_chrome_trace())
    if capacity == 6:
        assert mine.dropped > 0


def test_null_tracer_records_nothing():
    t = obs.NULL_TRACER
    assert not t.enabled
    t.begin("x", "request", 1)
    with t.span("y"):
        pass
    t.counter("q", 1)
    assert t.events() == []
    assert obs.TRACKS == jobs.TRACKS


def test_manual_clock_matches_reference():
    a, b = obs.ManualClock(start=1.0, step=0.5), jobs.ManualClock(1.0, 0.5)
    assert [a() for _ in range(3)] == [b() for _ in range(3)]
    a.advance(2.0)
    b.advance(2.0)
    assert a.now == b.now
    with pytest.raises(ValueError):
        a.advance(-1.0)


def _drive_metrics(mod):
    reg = mod.MetricsRegistry(histogram_window=4)
    reg.counter("served", tenant="a").inc()
    reg.counter("served", tenant="a").inc(2)
    reg.counter("served", tenant="b").inc(0.5)
    reg.gauge("depth").set(3)
    reg.gauge("depth").inc(-1)
    reg.gauge("level", kind="x").set(7.25)
    for v in (5.0, 1.0, 4.0, 2.0, 3.0, 9.0):
        reg.histogram("latency_ms", op="run").observe(v)
    return reg


def test_metrics_snapshot_matches_reference():
    mine, theirs = _drive_metrics(obs), _drive_metrics(jobs)
    assert mine.snapshot() == theirs.snapshot()
    assert mine.counter("served", tenant="a") is \
        mine.counter("served", tenant="a")
    assert mine.histogram("latency_ms", op="run").percentile(0.5) == \
        theirs.histogram("latency_ms", op="run").percentile(0.5)
    with pytest.raises(ValueError, match="only go up"):
        mine.counter("served", tenant="a").inc(-1)


@pytest.mark.parametrize("name", ["mini_resnet18", "mini_resnet50"])
def test_stall_attribution_matches_reference(name):
    """The same plan through both packages' ``fifo_sim`` credit mode,
    then through both ``stall_attribution``s with the same measured
    seconds: the same section, key for key."""
    tcp = tc.compile(getattr(tcfg, name)(hw=8, width=16, stages=4), tc.MINI)
    jcp = jc.compile(getattr(jcfg, name)(hw=8, width=16, stages=4),
                     jc.TPU_INTERPRET)
    sections = []
    for cp, fifo, mod in ((tcp, fifo_sim, obs), (jcp, jfifo, jobs)):
        sim_cfg, scale = cp.plan.sim_config()
        outcome = fifo.simulate(sim_cfg, "credit")
        names = tuple(s.spec.name for s in cp.plan.streamed
                      if s.weight_words_per_row > 0)
        sections.append(mod.stall_attribution(
            wall_s=2.0, admission_wait_s=0.25, dispatch_gap_s=0.5,
            modelled=outcome, engine_names=names, word_scale=scale))
        with pytest.raises(ValueError, match="drifted"):
            mod.stall_attribution(wall_s=1.0, admission_wait_s=0.0,
                                  dispatch_gap_s=0.0, modelled=outcome,
                                  engine_names=names[1:])
    assert sections[0] == sections[1]
    assert sections[0]["measured"]["admission_wait_fraction"] == 0.125
    assert sections[0]["modelled"]["cycles"] > 0
    assert obs.stall_attribution(wall_s=0.0, admission_wait_s=0.0,
                                 dispatch_gap_s=0.0) == \
        jobs.stall_attribution(wall_s=0.0, admission_wait_s=0.0,
                               dispatch_gap_s=0.0)


@pytest.fixture(scope="module")
def served():
    cfg = tcfg.mini_resnet18(hw=8, width=16, stages=4)
    cp = tc.compile(cfg, tc.MINI)
    params = init_cnn_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    shape = cnn_input_shape(cfg, 1)[1:]
    reqs = [rng.integers(-127, 128, size=(n,) + shape, dtype=np.int8)
            for n in (1, 2, 3, 1)]
    return cp, params, reqs


def test_traced_serving_exports_a_valid_trace(served):
    cp, params, reqs = served
    tr = obs.Tracer()
    with cp.serve(params, microbatch=4, credits=2, tracer=tr,
                  device="cpu") as eng:
        assert eng.tracer is tr
        outs, rep = eng.serve(reqs)
    for o, r in zip(outs, reqs):
        want, _ = cp.run(params, torch.from_numpy(r), device="cpu")
        np.testing.assert_array_equal(o, want.numpy())
    trace = tr.to_chrome_trace()
    assert obs.validate_chrome_trace(trace,
                                     require_tracks=SERVING_TRACKS) == []
    begins = [e for e in trace["traceEvents"]
              if e["ph"] == "b" and e["cat"] == "request"]
    assert len(begins) == len(reqs) == rep.requests


def test_manual_clock_serving_is_sleep_free(served):
    cp, params, reqs = served
    clk = obs.ManualClock(step=0.001)
    with cp.serve(params, microbatch=4, credits=2, clock=clk,
                  device="cpu") as eng:
        _, rep = eng.serve(reqs)
    assert eng._clock is clk and eng.admission.clock is clk
    assert rep.wall_s > 0 and 0 < rep.p50_ms <= rep.p95_ms <= rep.p99_ms
    for row in rep.request_rows:
        ticks = row["latency_ms"] / (1e3 * 0.001)
        assert ticks == pytest.approx(round(ticks))
    be = rep.bandwidth_efficiency
    assert be["wall_s"] == rep.wall_s
    assert 0.0 <= be["measured"]["dispatch_gap_fraction"] <= 1.0


def test_compile_and_run_record_pass_timings_and_cache_gauges(served):
    cp, params, _ = served
    cp.run(params, torch.zeros(cnn_input_shape(cp.cfg, 2),
                               dtype=torch.int8), device="cpu")
    snap = obs.default_registry().snapshot()
    for p in ("parallelism", "placement", "fifo_sizing", "finalize",
              "trace_fused"):
        key = f"compile_pass_seconds{{pass={p}}}"
        assert snap["histograms"][key]["count"] >= 1, key
    stats = cp.trace_cache_stats()
    g = snap["gauges"]
    assert g["compile_trace_cache{counter=hits}"] == stats["hits"]
    assert g["compile_trace_cache{counter=misses}"] == stats["misses"]
