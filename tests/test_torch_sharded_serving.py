"""The port's sharded serving engine on CPU stage meshes.

``mini_resnet18(hw=8, width=16, stages=4)`` (3 streamed layers) served by
``cp.serve_sharded`` on 1-, 2- and 4-stage meshes of ``["cpu"] * S``:
mixed request sizes that cross microbatch and round boundaries must be
bit-identical to the port's ``run(device="cpu")`` and to the JAX
package's jitted plain ``cnn_forward``.  The rest pins the engine's
contract as tests/test_sharded_serving.py pins the JAX one: the staged
accounting (rounds, fill, shard requests, per-stage words), the credit
bound and quiescence, explicit routing, validation and lifecycle, a
stage that raises failing its requests, and the report's JSON, which the
JAX package's ``ShardedServingReport.from_json`` must read.
"""
import dataclasses
import json
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cnn as jcfg
from repro.models.cnn import cnn_forward as jax_cnn_forward
from repro.runtime.sharded_serving import \
    ShardedServingReport as JaxShardedServingReport
from repro_torch import compiler as tc
from repro_torch.configs import cnn as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models.cnn import cnn_input_shape
from repro_torch.obs import Tracer
from repro_torch.runtime.sharded_serving import (ShardedCnnServingEngine,
                                                 ShardedServingReport)
from torch_testdata import numpy_cnn_params

JMINI = jcfg.mini_resnet18(hw=8, width=16, stages=4)
MINI = tcfg.mini_resnet18(hw=8, width=16, stages=4)
STAGE_COUNTS = (1, 2, 4)


@pytest.fixture(scope="module")
def setup():
    np_params = numpy_cnn_params(MINI, seed=0)
    cp = tc.compile(MINI, tc.MINI)
    assert cp.streamed_names
    jfwd = jax.jit(lambda p, x: jax_cnn_forward(p, JMINI, x))
    return dict(cp=cp, np_params=np_params, jfwd=jfwd,
                params=params_from_numpy(np_params, "cpu"))


def _mesh(S):
    return compat_make_mesh((S,), ("model",), devices=["cpu"] * S)


def _requests(sizes, seed=0):
    rng = np.random.default_rng(seed)
    shape = cnn_input_shape(MINI, 1)[1:]
    return [rng.integers(-127, 128, size=(n,) + shape,
                         dtype=np.int16).astype(np.int8) for n in sizes]


def _references(setup, batches):
    """Per request: the port's run(device="cpu") and the JAX package's
    plain forward over all the images at once (engines are per image)."""
    big = np.concatenate(batches, axis=0)
    run = setup["cp"].run(setup["params"], torch.from_numpy(big),
                          device="cpu")[0].numpy()
    want = np.asarray(setup["jfwd"](setup["np_params"], jnp.asarray(big)))
    np.testing.assert_array_equal(run, want)
    out, off = [], 0
    for b in batches:
        out.append(want[off:off + len(b)])
        off += len(b)
    return out


def _check_accounting(eng, rep, batches):
    """What holds for any packing the timing produced."""
    M, mb = eng.round_microbatches, eng.microbatch
    images = sum(len(b) for b in batches)
    assert rep.requests == len(batches) and rep.images == images
    assert rep.n_stages == eng.n_stages and rep.round_microbatches == M
    assert rep.microbatches + rep.empty_microbatches == rep.rounds * M
    assert rep.microbatches * mb - rep.padded_rows == images
    assert rep.dispatched_rows == rep.rounds * M * mb
    assert rep.hbm_words_executed == rep.dispatched_rows \
        * rep.hbm_words_per_image
    assert rep.hbm_words_useful == images * rep.hbm_words_per_image
    assert rep.round_fill_fraction == rep.microbatches / (rep.rounds * M)
    assert rep.stage_hbm_words_per_image == tuple(
        s.hbm_words_per_image for s in eng.partition.stages)
    assert sum(rep.stage_hbm_words_per_image) == rep.hbm_words_per_image
    assert rep.max_in_flight <= rep.credits == eng.admission.capacity
    assert sum(rep.shard_requests) == len(batches)
    eng.admission.assert_quiescent()


@pytest.mark.parametrize("S", STAGE_COUNTS)
def test_sharded_bit_identical_to_run_and_jax(setup, S):
    """Mixed sizes spanning microbatches (2 images) and rounds (3
    microbatches), round-robin over the shards."""
    batches = _requests([1, 3, 2, 7, 1, 4, 5, 2, 6])
    traces = setup["cp"].trace_cache_stats()
    with setup["cp"].serve_sharded(setup["params"], mesh=_mesh(S),
                                   microbatch=2,
                                   round_microbatches=3) as eng:
        results, rep = eng.serve(batches)
    # the stage captures stay the engine's: the trace cache is untouched
    assert setup["cp"].trace_cache_stats() == traces == rep.trace_cache
    for got, want in zip(results, _references(setup, batches)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    _check_accounting(eng, rep, batches)
    rr = [len(range(i, len(batches), S)) for i in range(S)]
    assert rep.shard_requests == tuple(rr)
    assert eng.partition.n_stages == S and rep.credits == 6


@pytest.mark.parametrize("S", STAGE_COUNTS)
def test_one_request_accounting_is_exact(setup, S):
    """One request of 9 images through microbatches of 2 and rounds of
    2: five packs (2, 2, 2, 2, 1) in three rounds, the last short."""
    batches = _requests([9], seed=3)
    with setup["cp"].serve_sharded(setup["params"], mesh=_mesh(S),
                                   microbatch=2,
                                   round_microbatches=2) as eng:
        req = eng.submit(batches[0], shard=S - 1)
        eng.drain()
        rep = eng.report()
    np.testing.assert_array_equal(req.result(),
                                  _references(setup, batches)[0])
    assert (rep.rounds, rep.microbatches, rep.empty_microbatches,
            rep.padded_rows) == (3, 5, 1, 1)
    assert rep.round_fill_fraction == 5 / 6
    assert rep.shard_requests == (0,) * (S - 1) + (1,)
    assert rep.dispatched_rows == 12 and rep.max_in_flight <= 4
    _check_accounting(eng, rep, batches)


@pytest.mark.parametrize("S", STAGE_COUNTS)
def test_stage_captures_carry_the_stage_plans(setup, S):
    """start() kept one stage program a stage, whose capture stats are
    the stage's Eq. 2 template (what it cross-checked)."""
    eng = setup["cp"].serve_sharded(setup["params"], mesh=_mesh(S),
                                    microbatch=2)
    assert eng.round_microbatches == 8 * S and \
        eng.admission.capacity == 16 * S
    with eng:
        assert len(eng.stage_programs) == S
        for s in range(S):
            want = eng.partition.stage_report(s, 2).layers
            assert [dataclasses.astuple(st) for st in eng.stage_stats[s]] \
                == [dataclasses.astuple(st) for st in want]


def test_explicit_shard_routing(setup):
    """Explicit routing lands requests on the chosen producer queues;
    results stay bit-identical whatever the routing."""
    S = 4
    batches = _requests([2, 3, 1, 4, 2], seed=5)
    shards = [3, 3, 0, 2, 3]
    with setup["cp"].serve_sharded(setup["params"], mesh=_mesh(S),
                                   microbatch=2,
                                   round_microbatches=2) as eng:
        reqs = [eng.submit(b, shard=k) for b, k in zip(batches, shards)]
        eng.drain()
        rep = eng.report()
    assert rep.shard_requests == (1, 0, 1, 3)
    for r, want in zip(reqs, _references(setup, batches)):
        np.testing.assert_array_equal(r.result(), want)
    _check_accounting(eng, rep, batches)


def test_concurrent_producers_hold_the_credit_bound(setup):
    """Four producers against a 4-stage ring with a short switch
    interval: every request bit-identical, the credits never exceeded,
    quiescent at stop."""
    batches = _requests([int(n) for n in
                         np.random.default_rng(7).integers(1, 6, 24)],
                        seed=7)
    handles = [None] * len(batches)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with setup["cp"].serve_sharded(setup["params"], mesh=_mesh(4),
                                       microbatch=2, round_microbatches=4,
                                       credits=4) as eng:
            def producer(pid):
                for i in range(pid, len(batches), 4):
                    handles[i] = eng.submit(batches[i])
            threads = [threading.Thread(target=producer, args=(p,))
                       for p in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
            eng.drain(timeout=120)
            rep = eng.report()
    finally:
        sys.setswitchinterval(old)
    for h, want in zip(handles, _references(setup, batches)):
        np.testing.assert_array_equal(h.result(), want)
    _check_accounting(eng, rep, batches)
    assert rep.max_in_flight <= 4


def test_validation_and_lifecycle(setup):
    cp, params = setup["cp"], setup["params"]
    mesh = _mesh(1)
    with pytest.raises(ValueError, match="no axis"):
        ShardedCnnServingEngine(cp, params, mesh=mesh, axis="data")
    with pytest.raises(ValueError, match="credits"):
        ShardedCnnServingEngine(cp, params, mesh=mesh,
                                round_microbatches=8, credits=4)
    with pytest.raises(ValueError, match="round_microbatches"):
        ShardedCnnServingEngine(cp, params, mesh=mesh, round_microbatches=0)
    with pytest.raises(ValueError, match="microbatch"):
        ShardedCnnServingEngine(cp, params, mesh=mesh, microbatch=0)
    with pytest.raises(ValueError, match="mixes device types"):
        ShardedCnnServingEngine(cp, params, mesh=compat_make_mesh(
            (2,), ("model",), devices=["cpu", "cuda:0"]))
    with pytest.raises(tc.PartitionError):
        ShardedCnnServingEngine(cp, params, mesh=_mesh(64))
    eng = ShardedCnnServingEngine(cp, params, mesh=mesh, microbatch=2,
                                  round_microbatches=2)
    with pytest.raises(RuntimeError, match="not started"):
        eng.submit(_requests([1])[0])
    with eng:
        with pytest.raises(ValueError, match="shard"):
            eng.submit(_requests([1])[0], shard=5)
        with pytest.raises(ValueError, match="expected images"):
            eng.submit(np.zeros((1, 3, 3, 3), np.int8))
        req = eng.submit(_requests([2])[0][0], shard=0)   # one [H,W,C]
        eng.drain()
        assert req.done and req.result().shape == (1, MINI.num_classes)
    eng.admission.assert_quiescent()
    with pytest.raises(RuntimeError, match="single-use"):
        eng.start()
    eng.stop()                                  # a stopped engine: no-op


def test_cuda_mesh_without_a_card_raises(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mesh = compat_make_mesh((2,), ("model",), devices=["cuda:0"] * 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        setup["cp"].serve_sharded(setup["params"], mesh=mesh)


def test_a_stage_that_raises_fails_its_requests(setup):
    """A stage program that raises mid-serve fails the requests of its
    round and every queued one; drain() raises, nothing hangs, and stop()
    returns."""
    batches = _requests([2, 3, 4, 1, 2, 2], seed=11)
    eng = setup["cp"].serve_sharded(setup["params"], mesh=_mesh(2),
                                    microbatch=2, round_microbatches=2)
    eng.start()
    real = eng.stage_programs[1]
    calls = []

    def broken(p, x):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("stage 1 fault")
        return real(p, x)
    eng._ring.fns[1] = broken
    reqs = [eng.submit(b) for b in batches]
    with pytest.raises(RuntimeError, match="failed"):
        eng.drain(timeout=60)
    failed = 0
    for r in reqs:
        assert r._event.wait(60)
        try:
            r.result()
        except RuntimeError as e:
            failed += 1
            assert "stage 1 fault" in repr(e.__cause__)
    assert failed >= 1
    with pytest.raises(RuntimeError, match="failed"):
        eng.submit(batches[0])
    eng.stop()
    assert eng._error is not None and not eng._started


def test_tracer_spans_and_metrics(setup):
    tracer = Tracer()
    with setup["cp"].serve_sharded(setup["params"], mesh=_mesh(2),
                                   microbatch=2, round_microbatches=2,
                                   tracer=tracer) as eng:
        _, rep = eng.serve(_requests([3, 2, 4], seed=13))
    names = {(ev[0], ev[1]) for ev in tracer.events()}
    for want in (("X", "pack"), ("X", "credit_wait"), ("X", "dispatch"),
                 ("X", "deliver"), ("b", "round"), ("e", "round"),
                 ("i", "stage_round"), ("b", "request"), ("e", "request"),
                 ("C", "queue_depth")):
        assert want in names, want
    c = rep.metrics["counters"]
    assert c["serving_rounds"] == rep.rounds
    assert c["serving_microbatches"] == rep.microbatches
    assert c["serving_empty_microbatches"] == rep.empty_microbatches
    assert c["serving_requests_done"] == 3


def test_report_round_trip_and_jax_reads_it(setup):
    """``from_json`` restores the tuple-typed staged fields to equality,
    and the JAX package's ``ShardedServingReport.from_json`` reads the
    port's JSON with the same keys and values."""
    with setup["cp"].serve_sharded(setup["params"], mesh=_mesh(4),
                                   microbatch=2,
                                   round_microbatches=2) as eng:
        _, rep = eng.serve(_requests([1, 3, 2], seed=9))
    assert rep.stage_hbm_words_per_image and rep.shard_requests
    back = ShardedServingReport.from_json(rep.to_json())
    assert back == rep
    assert isinstance(back.stage_hbm_words_per_image, tuple)
    assert isinstance(back.shard_requests, tuple)
    assert ShardedServingReport.from_json(rep.to_dict()) == rep
    jrep = JaxShardedServingReport.from_json(rep.to_json())
    assert set(jrep.to_dict()) == set(rep.to_dict())
    assert json.loads(jrep.to_json()) == json.loads(rep.to_json())
    assert jrep.round_fill_fraction == rep.round_fill_fraction
