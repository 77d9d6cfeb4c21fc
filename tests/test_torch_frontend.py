"""The port's multi-tenant front end (``runtime/frontend.py``) on the CPU.

Three mini nets (ResNet-18, ResNet-50 and MobileNet topologies) are
compiled by the port and served by its engines (``device="cpu"``, the
plain versions) behind one ``MultiTenantFrontEnd``.  Every request's
logits must equal the JAX package's plain ``cnn_forward`` on the same
numpy params and images, bit for bit: weighted-fair scheduling and
deadline promotion reorder service, never an output bit.  The rest holds
the front end's own contract as tests/test_frontend.py holds the JAX
one: the front-end-wide credit bound under concurrent producers (and
each engine's), 1:4 delivered shares under backlog with a high Jain
index, deadline promotion, tenant-labelled counters and
``tenant:<name>`` trace tracks, validation and lifecycle.  The report's
JSON has the JAX report's keys (the JAX front end, framework-free, is
run here over the port's engines to get them) and is read back by the
JAX package's ``FrontEndReport.from_json``.
"""
import dataclasses
import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import cnn as jcfg
from repro.models.cnn import cnn_forward as jax_cnn_forward
from repro.runtime import frontend as jfe
from repro_torch import compiler as tc
from repro_torch.configs import cnn as tcfg
from repro_torch.convert import params_from_numpy
from repro_torch.models.cnn import cnn_input_shape
from repro_torch.obs import Tracer, validate_chrome_trace
from repro_torch.runtime.frontend import (FrontEndReport, FrontEndRequest,
                                          MultiTenantFrontEnd, TenantSpec)
from torch_testdata import numpy_cnn_params

NETS = {
    "mini_resnet18": dict(hw=8, width=16, stages=4),
    "mini_resnet50": dict(hw=8, width=16, stages=4),
    "mini_mobilenet": dict(hw=8, width=16, blocks=4),
}
REF_BATCH = 8


@pytest.fixture(scope="module")
def nets():
    """net name -> (port pipeline, port params, numpy params)."""
    out = {}
    for i, (name, kw) in enumerate(NETS.items()):
        cfg = getattr(tcfg, name)(**kw)
        np_params = numpy_cnn_params(cfg, seed=10 + i)
        out[name] = (tc.compile(cfg, tc.MINI),
                     params_from_numpy(np_params, "cpu"), np_params)
    assert out["mini_resnet18"][0].streamed_names
    return out


def _requests(name, sizes, seed=0):
    cfg = getattr(tcfg, name)(**NETS[name])
    rng = np.random.default_rng(seed)
    shape = cnn_input_shape(cfg, 1)[1:]
    return [rng.integers(-127, 128, size=(n,) + shape,
                         dtype=np.int16).astype(np.int8) for n in sizes]


@functools.lru_cache(None)
def _jax_forward(name):
    """The JAX package's plain ``cnn_forward`` for one net, jitted once
    (it is called at one shape, REF_BATCH images)."""
    cfg = getattr(jcfg, name)(**NETS[name])
    return jax.jit(lambda p, x: jax_cnn_forward(p, cfg, x))


def _jax_rows(nets, name, batches):
    """The JAX package's plain ``cnn_forward`` over the concatenated
    images, REF_BATCH at a time (the last run zero-padded), split back
    per request: every engine is per-image."""
    np_params = nets[name][2]
    big = np.concatenate(batches, axis=0)
    pad = -len(big) % REF_BATCH
    big = np.concatenate([big, np.zeros((pad,) + big.shape[1:], np.int8)])
    ref = np.concatenate([
        np.asarray(_jax_forward(name)(np_params,
                                      jnp.asarray(big[i:i + REF_BATCH])))
        for i in range(0, len(big), REF_BATCH)])
    out, off = [], 0
    for b in batches:
        out.append(ref[off:off + len(b)])
        off += len(b)
    return out


def _engine(nets, name, **kw):
    cp, params = nets[name][:2]
    return cp.serve(params, device="cpu", **kw)


def test_three_network_traffic_bit_identical_to_jax(nets):
    """Closed-loop ``serve()`` and open-loop submit/collect across all
    three nets at once."""
    fe = MultiTenantFrontEnd(
        {n: _engine(nets, n, microbatch=4, credits=2, queue_depth=4)
         for n in nets}, max_outstanding=6)
    tenant_of = {"mini_resnet18": "a18", "mini_resnet50": "a50",
                 "mini_mobilenet": "amb"}
    for n, t in tenant_of.items():
        fe.register_tenant(t, network=n, weight=2.0 if "50" in n else 1.0)
    per_net = {n: _requests(n, [1, 3, 2, 5, 6], seed=100 + i)
               for i, n in enumerate(nets)}
    with fe:
        closed, _ = fe.serve([(tenant_of[n], b) for n in per_net
                              for b in per_net[n][:2]])
        open_reqs = [(n, fe.submit(tenant_of[n], per_net[n][i]))
                     for i in (2, 3, 4) for n in per_net]
        fe.drain()
        rep = fe.report()
    want = {n: _jax_rows(nets, n, per_net[n]) for n in per_net}
    got = iter(closed)
    for n in per_net:
        for i in range(2):
            np.testing.assert_array_equal(next(got), want[n][i])
    seen = {n: 2 for n in per_net}
    for n, req in open_reqs:
        assert isinstance(req, FrontEndRequest) and req.done
        np.testing.assert_array_equal(req.result(), want[n][seen[n]])
        seen[n] += 1
    assert rep.requests == 15
    assert rep.images == 3 * 17
    assert rep.networks == tuple(sorted(nets))
    assert fe.admission.max_in_flight_seen <= 6


def test_concurrent_producers_hold_admission_invariants(nets):
    name = "mini_resnet18"
    fe = MultiTenantFrontEnd(
        {name: _engine(nets, name, microbatch=4, credits=2, queue_depth=2)},
        max_outstanding=3)
    tenants = ["t0", "t1", "t2"]
    for t in tenants:
        fe.register_tenant(t, network=name)
    batches = {t: _requests(name, [1, 2, 1, 3, 4], seed=i)
               for i, t in enumerate(tenants)}
    got, errors = {}, []

    def producer(t):
        try:
            got[t] = [fe.submit(t, b) for b in batches[t]]
        except BaseException as exc:          # pragma: no cover
            errors.append(exc)

    with fe:
        threads = [threading.Thread(target=producer, args=(t,))
                   for t in tenants]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors
        fe.drain()
        fe.admission.check_invariants()
    ctl = fe.admission
    assert ctl.max_in_flight_seen <= 3
    assert ctl.admitted_total == ctl.completed_total == 15
    ctl.assert_quiescent()
    eng = fe._lanes[name].engine
    assert eng.admission.max_in_flight_seen <= 2
    eng.admission.assert_quiescent()
    for t in tenants:
        for req, want in zip(got[t], _jax_rows(nets, name, batches[t])):
            np.testing.assert_array_equal(req.result(), want)


def test_weighted_shares_track_weights_under_backlog(nets):
    """1:4 weights on one net with one request in service at a time: a
    mid-run snapshot, while both tenants are backlogged, delivers 4
    within 20% and a Jain index over weight-normalised shares >= 0.95."""
    name = "mini_resnet18"
    fe = MultiTenantFrontEnd(
        {name: _engine(nets, name, microbatch=1, credits=1, queue_depth=1)},
        max_outstanding=1)
    fe.register_tenant("light", network=name, weight=1.0)
    fe.register_tenant("heavy", network=name, weight=4.0)
    n_each = 30
    batches = _requests(name, [1] * n_each, seed=0)
    with fe:
        for b in batches:
            fe.submit("light", b)
            fe.submit("heavy", b)
        while True:
            rep = fe.report()
            done = {r["tenant"]: r["images"] for r in rep.tenant_rows}
            if sum(done.values()) >= 25:
                break
            time.sleep(0.002)
        fe.drain()
        final = fe.report()
    ratio = done["heavy"] / max(1, done["light"])
    assert 4.0 * 0.8 <= ratio <= 4.0 * 1.2, (done, ratio)
    assert rep.fairness >= 0.95
    rows = {r["tenant"]: r for r in final.tenant_rows}
    assert rows["light"]["images"] == rows["heavy"]["images"] == n_each
    assert rows["heavy"]["picks"] + rows["light"]["picks"] == 2 * n_each
    assert rows["heavy"]["served_cost"] == pytest.approx(n_each)


def test_deadline_promotion_jumps_the_line(nets):
    name = "mini_mobilenet"
    fe = MultiTenantFrontEnd(
        {name: _engine(nets, name, microbatch=1, credits=1, queue_depth=1)},
        max_outstanding=1)
    fe.register_tenant("bulk", network=name, weight=8.0)
    fe.register_tenant("rt", network=name, weight=1.0, deadline_ms=0.0)
    batches = _requests(name, [1] * 10, seed=1)
    with fe:
        reqs = [(fe.submit("bulk", b), fe.submit("rt", b)) for b in batches]
        fe.drain()
        rep = fe.report()
    rows = {r["tenant"]: r for r in rep.tenant_rows}
    assert rep.promotions > 0
    assert rows["rt"]["deadline_misses"] > 0
    assert rows["rt"]["deadline_miss_rate"] == \
        rows["rt"]["deadline_misses"] / rows["rt"]["requests"]
    assert rows["bulk"]["deadline_misses"] == 0
    assert rows["bulk"]["deadline_miss_rate"] == 0.0
    want = _jax_rows(nets, name, batches)
    for (bulk, rt), w in zip(reqs, want):
        np.testing.assert_array_equal(bulk.result(), w)
        np.testing.assert_array_equal(rt.result(), w)
        assert rt.missed and not bulk.missed


def test_tenant_labelled_obs_and_trace_tracks(nets):
    name = "mini_resnet18"
    tr = Tracer()
    fe = MultiTenantFrontEnd(
        {name: _engine(nets, name, microbatch=4, credits=2)}, tracer=tr)
    fe.register_tenant("alice", network=name)
    fe.register_tenant("bob", network=name)
    with fe:
        _, rep = fe.serve([("alice", b) for b in
                           _requests(name, [1, 2], seed=3)]
                          + [("bob", b) for b in
                             _requests(name, [3], seed=4)])
    c = rep.metrics["counters"]
    assert c["frontend_requests_submitted{tenant=alice}"] == 2
    assert c["frontend_requests_submitted{tenant=bob}"] == 1
    assert c["frontend_images_delivered{tenant=alice}"] == 3
    assert c["frontend_images_delivered{tenant=bob}"] == 3
    trace = tr.to_chrome_trace()
    assert validate_chrome_trace(trace) == []
    tracks = {e["args"]["name"] for e in trace["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"tenant:alice", "tenant:bob"} <= tracks
    begins = [e for e in trace["traceEvents"] if e["ph"] == "b"]
    ends = [e for e in trace["traceEvents"] if e["ph"] == "e"]
    assert len(begins) == len(ends) == 3


def _serve_solo(frontend_cls, nets, name):
    fe = frontend_cls({name: _engine(nets, name, microbatch=4, credits=2)})
    fe.register_tenant("solo", network=name, weight=2.0, deadline_ms=1e6)
    with fe:
        _, rep = fe.serve([("solo", b) for b in
                           _requests(name, [2, 1], seed=5)])
    return rep


def test_report_round_trip_and_jax_reads_it(nets):
    rep = _serve_solo(MultiTenantFrontEnd, nets, "mini_mobilenet")
    back = FrontEndReport.from_json(rep.to_json())
    assert back == rep
    assert isinstance(back.networks, tuple)
    assert isinstance(back.tenant_rows, tuple)
    assert FrontEndReport.from_json(rep.to_dict()) == rep
    text = rep.table()
    assert "fairness(Jain)" in text and "solo" in text
    assert "deadline promotions" in text
    jax_back = jfe.FrontEndReport.from_json(rep.to_json())
    assert dataclasses.asdict(jax_back) == rep.to_dict()
    assert jax_back.table() == text


def test_report_keys_equal_jax(nets):
    """The JAX front end over the port's engines: the same report keys,
    tenant-row keys and counter names as the port's front end."""
    got = _serve_solo(MultiTenantFrontEnd, nets, "mini_resnet50")
    want = _serve_solo(jfe.MultiTenantFrontEnd, nets, "mini_resnet50")
    assert set(got.to_dict()) == set(want.to_dict())
    assert [set(r) for r in got.tenant_rows] == \
        [set(r) for r in want.tenant_rows]
    for key in ("counters", "gauges", "histograms"):
        assert set(got.metrics.get(key, {})) == \
            set(want.metrics.get(key, {}))
    for f in ("requests", "images", "networks", "promotions"):
        assert getattr(got, f) == getattr(want, f)


def test_validation_and_lifecycle(nets):
    name = "mini_resnet18"
    with pytest.raises(ValueError, match="at least one"):
        MultiTenantFrontEnd({})
    fe = MultiTenantFrontEnd({name: _engine(nets, name, microbatch=2,
                                            credits=2)})
    with pytest.raises(ValueError, match="unknown network"):
        fe.register_tenant("x", network="nope")
    fe.register_tenant("x", network=name)
    with pytest.raises(ValueError, match="already"):
        fe.register_tenant("x", network=name)
    assert fe.tenants["x"] == TenantSpec("x", name, 1.0, None)
    img = _requests(name, [1], seed=6)[0]
    with pytest.raises(RuntimeError, match="not started"):
        fe.submit("x", img)
    with fe:
        with pytest.raises(ValueError, match="unknown tenant"):
            fe.submit("ghost", img)
        req = fe.submit("x", img[0])              # one image, no batch axis
        np.testing.assert_array_equal(
            req.result(timeout=60), _jax_rows(nets, name, [img])[0])
        assert req.latency_s > 0
    with pytest.raises(RuntimeError, match="single-use"):
        fe.start()


class _FailingEngine:
    """An engine whose requests fail: the front end must fail the
    handles, not hang, and refuse later submissions."""

    class _Req:
        def result(self, timeout=None):
            raise RuntimeError("engine fault")

    def start(self):
        pass

    def stop(self):
        pass

    def submit(self, images):
        return self._Req()


def test_engine_failure_fails_the_handles():
    fe = MultiTenantFrontEnd({"bad": _FailingEngine()}, max_outstanding=2)
    fe.register_tenant("t", network="bad")
    img = np.zeros((1, 8, 8, 3), np.int8)
    with fe:
        req = fe.submit("t", img)
        with pytest.raises(RuntimeError, match="failed"):
            req.result(timeout=60)
        with pytest.raises(RuntimeError, match="failed"):
            fe.drain(timeout=60)
        with pytest.raises(RuntimeError, match="failed"):
            fe.submit("t", img)
    assert fe.admission.in_flight == 0
