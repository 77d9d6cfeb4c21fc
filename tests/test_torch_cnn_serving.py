"""The port's CNN serving engine against the JAX package's, on the CPU.

The same seeded requests and params go through the port's
``CompiledPipeline.serve`` (``device="cpu"``) and, as the reference, the
JAX package's sequential ``run()``: every request's logits must be
bit-identical, rows spanning microbatches included.  The deterministic
one-request pack must give the JAX engine's integer report fields, and
the port's report JSON must have the JAX report's keys and be read back
by the JAX ``ServingReport.from_json``.  The rest pins the engine's own
contract as tests/test_cnn_serving.py pins the JAX one: credits never
exceeded under concurrent producers, one warm trace for any request mix,
the report's accounting, the lifecycle and the adaptive ladder.
"""
import dataclasses
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler as jc
from repro.configs import cnn as jcfg
from repro.runtime.cnn_serving import ServingReport as JaxServingReport
from repro_torch import compiler as tc
from repro_torch.configs import cnn as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.models.cnn import cnn_input_shape
from repro_torch.runtime.cnn_serving import (CnnServingEngine, ServingReport,
                                             restore_tuple_fields)
from torch_testdata import numpy_cnn_params

JMINI = jcfg.mini_resnet18(hw=8, width=16, stages=4)   # 3 streamed layers
MINI = tcfg.mini_resnet18(hw=8, width=16, stages=4)
MB = 4

# the integer fields of a report, which a deterministic pack fixes
INT_FIELDS = ("requests", "images", "microbatches", "microbatch_size",
              "padded_rows", "credits", "max_in_flight",
              "hbm_words_per_image", "hbm_words_useful",
              "hbm_words_executed", "dispatched_rows")


@pytest.fixture(scope="module")
def setup():
    """Seeded params in both packages, and the JAX pipeline whose
    ``run()`` at batch MB is the reference (one compiled program: every
    reference call and the JAX engine share that shape)."""
    np_params = numpy_cnn_params(MINI, seed=0)
    jcp = jc.compile(JMINI, jc.TPU_INTERPRET)
    cp = tc.compile(MINI, tc.MINI)
    assert cp.streamed_names
    return dict(jcp=jcp, jparams=np_params, cp=cp,
                params=params_from_numpy(np_params, "cpu"))


def _requests(sizes, seed=0):
    rng = np.random.default_rng(seed)
    shape = cnn_input_shape(MINI, 1)[1:]
    return [rng.integers(-127, 128, size=(n,) + shape,
                         dtype=np.int16).astype(np.int8) for n in sizes]


def _jax_rows(setup, batches):
    """Per-request logits from the JAX package's sequential ``run()`` over
    the concatenated images, MB at a time (the last run zero-padded;
    every engine is per-image)."""
    big = np.concatenate(batches, axis=0)
    pad = -len(big) % MB
    big = np.concatenate([big, np.zeros((pad,) + big.shape[1:], np.int8)])
    ref = np.concatenate([
        np.asarray(setup["jcp"].run(setup["jparams"],
                                    jnp.asarray(big[i:i + MB]))[0])
        for i in range(0, len(big), MB)])
    out, off = [], 0
    for b in batches:
        out.append(ref[off:off + len(b)])
        off += len(b)
    return out


def _serve(setup, **kw):
    return setup["cp"].serve(setup["params"], device="cpu", **kw)


def test_serving_bit_identical_to_jax_run(setup):
    """Mixed sizes, including requests larger than the microbatch (rows
    span dispatch boundaries)."""
    batches = _requests([1, 3, 2, 5, 1, 4, 2, 6])
    with _serve(setup, microbatch=MB, credits=3) as eng:
        results, report = eng.serve(batches)
    for got, want in zip(results, _jax_rows(setup, batches)):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert report.requests == len(batches)
    assert report.images == sum(len(b) for b in batches)
    assert report.max_in_flight <= 3


@pytest.fixture(scope="module")
def one_pack(setup):
    """ONE 5-image request through microbatch MB with one credit, on both
    engines: a full pack, then a 1-row flush with 3 padded rows."""
    batches = _requests([5], seed=5)
    with setup["jcp"].serve(setup["jparams"], microbatch=MB,
                            credits=1) as jeng:
        jres, jrep = jeng.serve(batches)
    with _serve(setup, microbatch=MB, credits=1) as eng:
        res, rep = eng.serve(batches)
    return dict(batches=batches, jres=jres, jrep=jrep, res=res, rep=rep)


def test_one_request_pack_matches_jax_engine(one_pack):
    rep, jrep = one_pack["rep"], one_pack["jrep"]
    assert {f: getattr(rep, f) for f in INT_FIELDS} == \
        {f: getattr(jrep, f) for f in INT_FIELDS}
    assert rep.microbatches == 2 and rep.padded_rows == 3
    assert rep.microbatch_shapes == jrep.microbatch_shapes
    assert rep.pad_fraction == jrep.pad_fraction
    np.testing.assert_array_equal(one_pack["res"][0],
                                  np.asarray(one_pack["jres"][0]))


def test_report_json_schema_matches_jax(one_pack):
    rep, jrep = one_pack["rep"], one_pack["jrep"]
    mine, theirs = json.loads(rep.to_json()), json.loads(jrep.to_json())
    assert set(mine) == set(theirs)
    for section in ("bandwidth_efficiency", "metrics"):
        assert set(mine[section]) == set(theirs[section])
    assert set(mine["bandwidth_efficiency"]["modelled"]) == \
        set(theirs["bandwidth_efficiency"]["modelled"])
    assert set(mine["metrics"]["counters"]) == \
        set(theirs["metrics"]["counters"])
    # the JAX package reads the port's report back, field for field
    back = JaxServingReport.from_json(rep.to_json())
    assert dataclasses.asdict(back) == dataclasses.asdict(rep)
    assert ServingReport.from_json(jrep.to_json()).to_dict() == \
        jrep.to_dict()


def test_serving_report_round_trip(one_pack):
    rep = one_pack["rep"]
    assert rep.metrics and rep.bandwidth_efficiency
    assert ServingReport.from_json(rep.to_json()) == rep
    assert ServingReport.from_json(rep.to_dict()) == rep


def test_modelled_stalls_match_jax(one_pack):
    """Both engines lay their measured fractions against the same
    ``fifo_sim`` outcome of the same plan."""
    assert one_pack["rep"].bandwidth_efficiency["modelled"] == \
        one_pack["jrep"].bandwidth_efficiency["modelled"]


def test_threaded_stress_never_exceeds_credits(setup):
    """N producers submitting concurrently; the admission invariant hooks
    prove at most ``credits`` microbatches were EVER in flight, and every
    result is bit-identical to the JAX reference."""
    rng = np.random.default_rng(7)
    sizes = [int(rng.integers(1, 6)) for _ in range(24)]
    batches = _requests(sizes, seed=7)
    credits, producers = 2, 6
    results = {}
    with _serve(setup, microbatch=MB, credits=credits) as eng:
        def producer(pid):
            for i in range(pid, len(batches), producers):
                results[i] = eng.submit(batches[i])
        threads = [threading.Thread(target=producer, args=(p,))
                   for p in range(producers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        eng.drain(timeout=120)
        report = eng.report()
    eng.admission.check_invariants()
    assert eng.admission.max_in_flight_seen <= credits
    assert report.max_in_flight <= credits
    assert eng.admission.admitted_total == eng.admission.completed_total \
        == report.microbatches
    for i, want in enumerate(_jax_rows(setup, batches)):
        np.testing.assert_array_equal(results[i].result(), want)
    assert report.requests == len(batches)


def test_one_warm_trace_for_any_request_mix(setup):
    cp = tc.compile(MINI, tc.MINI)                 # fresh, empty cache
    assert cp.trace_count == 0
    with cp.serve(setup["params"], microbatch=MB, credits=2,
                  device="cpu") as eng:
        eng.serve(_requests([1, 3, 2, 4, 1]))
    assert cp.trace_count == 1


def test_report_accounting(setup):
    batches = _requests([2, 1, 3, 1])              # 7 images
    with _serve(setup, microbatch=MB, credits=4) as eng:
        _, report = eng.serve(batches)
        per_image = eng.words_per_image
    assert per_image == sum(setup["cp"].plan.hbm_words_per_image().values())
    assert per_image > 0
    by_rid = {r["rid"]: r for r in report.request_rows}
    for rid, batch in enumerate(batches, start=1):
        assert by_rid[rid]["hbm_words"] == len(batch) * per_image
        assert by_rid[rid]["images"] == len(batch)
        assert by_rid[rid]["latency_ms"] > 0
    assert report.hbm_words_useful == 7 * per_image
    assert report.microbatches * MB == report.images + report.padded_rows
    assert report.hbm_words_executed == \
        report.microbatches * MB * per_image >= report.hbm_words_useful
    assert 0 <= report.pad_fraction < 1
    assert report.p50_ms <= report.p95_ms <= report.p99_ms
    assert report.images_per_s > 0
    assert report.queue_depth and all(d >= 0 for _, d in report.queue_depth)
    counters = report.metrics["counters"]
    assert counters["serving_requests_done"] == len(batches)
    assert counters["serving_microbatches"] == report.microbatches
    assert report.metrics["histograms"]["serving_latency_ms"]["count"] == 4
    text = report.table()
    assert "images/s" in text and "trace cache:" in text


def test_lifecycle_and_validation(setup):
    cp, params = setup["cp"], setup["params"]
    eng = CnnServingEngine(cp, params, microbatch=2, credits=1, device="cpu")
    with pytest.raises(RuntimeError, match="not started"):
        eng.submit(_requests([1])[0])
    with eng:
        with pytest.raises(ValueError, match="expected images"):
            eng.submit(np.zeros((1, 5, 5, 3), np.int8))
        req = eng.submit(_requests([1])[0][0])     # one [H,W,C] image
        assert req.result(timeout=60).shape[0] == 1
        assert req.latency_s > 0
    eng.admission.assert_quiescent()
    with pytest.raises(RuntimeError, match="single-use"):
        eng.start()
    with pytest.raises(ValueError, match="microbatch"):
        CnnServingEngine(cp, params, microbatch=0, device="cpu")


def test_compiled_pipeline_serve_entry_point(setup):
    eng = _serve(setup, microbatch=MB)
    assert isinstance(eng, CnnServingEngine)
    assert eng.admission.capacity == 4               # the default credits
    assert eng.device.type == "cpu"
    with eng:
        res, report = eng.serve(_requests([1, 2]))
    assert len(res) == 2 and report.images == 3


def test_serving_refuses_the_card_without_one(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        setup["cp"].serve(setup["params"])


def test_submit_losing_race_to_stop_leaves_accounting_clean(setup):
    eng = _serve(setup, microbatch=2, credits=2)
    eng.start()
    try:
        eng._accepting = False                   # stop() won the race
        with pytest.raises(RuntimeError, match="stopping"):
            eng.submit(_requests([1])[0])
        assert eng._t0 is None
        counters = eng.metrics.snapshot()["counters"]
        assert counters.get("serving_requests_submitted", 0) == 0
        eng._accepting = True
        batches = _requests([1, 2], seed=7)
        outs, rep = eng.serve(batches)
        for got, want in zip(outs, _jax_rows(setup, batches)):
            np.testing.assert_array_equal(got, want)
        assert rep.requests == 2
        counters = eng.metrics.snapshot()["counters"]
        assert counters["serving_requests_submitted"] == 2
    finally:
        eng.stop()
    eng.admission.assert_quiescent()


def test_adaptive_ladder_validation(setup):
    cp, params = setup["cp"], setup["params"]
    with pytest.raises(ValueError, match="topping"):
        CnnServingEngine(cp, params, microbatch=4, microbatch_ladder=[1, 2],
                         device="cpu")
    with pytest.raises(ValueError, match="topping"):
        CnnServingEngine(cp, params, microbatch=4, microbatch_ladder=[0, 4],
                         device="cpu")
    assert cp.trace_cache_size < 11
    with pytest.raises(ValueError, match="trace cache"):
        CnnServingEngine(cp, params, microbatch=1024, adaptive=True,
                         device="cpu")
    eng = CnnServingEngine(cp, params, microbatch=4, device="cpu")
    assert eng.microbatch_ladder == (4,) and not eng.adaptive
    eng = CnnServingEngine(cp, params, microbatch=4,
                           microbatch_ladder=[1, 4], device="cpu")
    assert eng.adaptive and eng.microbatch_ladder == (1, 4)


def test_adaptive_shapes_follow_queue_depth(setup):
    """Light load dispatches the smallest fitting rung, a burst grows back
    to the full microbatch, and every shape stays bit-identical."""
    with _serve(setup, microbatch=MB, credits=2, adaptive=True) as eng:
        assert eng.microbatch_ladder == (1, 2, 4)
        singles = _requests([1, 1, 1], seed=11)
        single_reqs = []
        for b in singles:
            r = eng.submit(b)
            r.result(timeout=60)
            single_reqs.append(r)
        burst = _requests([8], seed=12)
        outs, rep = eng.serve(burst)
    shapes = rep.microbatch_shapes
    assert shapes.get("1", 0) >= 3
    assert shapes.get("4", 0) >= 2
    assert rep.dispatched_rows == sum(int(k) * v for k, v in shapes.items())
    assert rep.hbm_words_executed == \
        rep.dispatched_rows * rep.hbm_words_per_image
    assert rep.padded_rows == rep.dispatched_rows - rep.images
    wants = _jax_rows(setup, singles + burst)
    for got, want in zip([r.result() for r in single_reqs] + outs, wants):
        np.testing.assert_array_equal(got, want)
    tc_stats = rep.trace_cache
    assert tc_stats["entries"] <= tc_stats["max_entries"]


def test_restore_tuple_fields_deep_nesting():
    from typing import Dict, Tuple

    @dataclasses.dataclass
    class Nested:
        rows: Tuple[Tuple[int, ...], ...] = ()
        pairs: Tuple[Tuple[str, int], ...] = ()
        plain: Dict[str, int] = dataclasses.field(default_factory=dict)

    orig = Nested(rows=((1, 2), (3,)), pairs=(("a", 1), ("b", 2)),
                  plain={"x": 1})
    payload = json.loads(json.dumps(dataclasses.asdict(orig)))
    back = Nested(**restore_tuple_fields(Nested, payload))
    assert back == orig
    assert isinstance(back.rows[0], tuple)
    payload["derived_rate"] = 123.0
    assert Nested(**restore_tuple_fields(Nested, payload)) == orig
