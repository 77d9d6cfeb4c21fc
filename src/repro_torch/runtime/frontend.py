"""Multi-tenant, multi-network serving front-end.

One H2PIPE deployment rarely serves one model: the paper's premise is a
*library* of CNNs (ResNet-18/50, MobileNet) each compiled to its own
deeply pipelined accelerator, and a datacenter box hosts several at
once.  This module is the admission tier ABOVE the per-network serving
engines: tenants register against a network with a weight and an
optional latency deadline, submit requests through one front door, and
a weighted-fair scheduler decides whose request each engine sees next.

Layering (nothing below this tier changes):

  * the per-network serving engines
    (:class:`~repro_torch.runtime.cnn_serving.CnnServingEngine`) keep
    their own §V-A credit bounds, packers, CUDA streams and graph
    traces (engines on one card capture one at a time,
    ``compiler/pipeline.py::_CAPTURE_LOCK``);
  * :class:`~repro_torch.core.admission.WeightedFairScheduler` (deficit
    round-robin + deadline promotion) orders the per-tenant queues of
    each network — long-run delivered images/s tracks tenant weights
    while a request whose deadline slack goes negative jumps the line;
  * an optional front-end-wide
    :class:`~repro_torch.core.admission.AdmissionController`
    (``max_outstanding``) bounds total in-flight requests across ALL
    networks — the global tier whose invariant hooks the stress tests
    assert under concurrent multi-tenant producers;
  * each engine's small ``queue_depth`` is the backpressure that makes
    the scheduler meaningful: the engine queue fills, ``submit`` blocks
    the forwarding thread, and the backlog pools HERE where DRR (not
    FIFO arrival order) picks what goes next.

Observability rides the shared obs subsystem: tenant-labelled counters
on the front-end :class:`~repro_torch.obs.metrics.MetricsRegistry`, one trace
track per tenant (``tenant:<name>`` — the Tracer admits new tracks on
first use), and :class:`FrontEndReport` with per-tenant latency
percentiles, deadline-miss rates, and Jain's fairness index over
weight-normalized delivered throughput.  Requests and results are numpy
arrays at the front door, as at the engines'.  The module is a copy of
the JAX package's ``runtime/frontend.py``, and the report's JSON keeps
its schema, so the JAX package's ``FrontEndReport.from_json`` reads it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import queue
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.core.admission import (AdmissionController, HeadOfQueue,
                                        WeightedFairScheduler,
                                        jain_fairness)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, monotonic_clock
from repro_torch.runtime.cnn_serving import (METRIC_WINDOW,
                                             restore_tuple_fields)

__all__ = ["FrontEndReport", "FrontEndRequest", "MultiTenantFrontEnd",
           "TenantSpec"]

_STOP = object()


@dataclass(frozen=True)
class TenantSpec:
    """One registered tenant: which network it runs on, its weighted
    share, and (optionally) its per-request latency deadline."""

    name: str
    network: str
    weight: float = 1.0
    deadline_ms: Optional[float] = None


class FrontEndRequest:
    """One tenant-submitted request as the front door sees it: holds the
    images until the scheduler forwards them to the network's engine,
    then proxies the engine-side handle.  ``deadline`` is absolute on
    the front-end clock (``t_submit + deadline_ms``); :attr:`missed`
    is judged at delivery time."""

    def __init__(self, rid: int, tenant: str, network: str,
                 images: np.ndarray, now: float,
                 deadline_ms: Optional[float] = None):
        self.rid = rid
        self.tenant = tenant
        self.network = network
        self.images = images
        self.n = int(images.shape[0])
        self.t_submit = now
        self.deadline = now + deadline_ms / 1e3 \
            if deadline_ms is not None else None
        self.t_forward: Optional[float] = None
        self.t_done: Optional[float] = None
        self.missed = False
        self._logits: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self._event = threading.Event()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency_s(self) -> float:
        if self.t_done is None:
            raise RuntimeError(f"request {self.rid} not complete")
        return self.t_done - self.t_submit

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until delivered; returns logits ``[n, classes]``."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done in {timeout}s")
        if self._error is not None:
            raise RuntimeError(
                f"request {self.rid} ({self.tenant}) failed"
            ) from self._error
        return self._logits

    def _deliver(self, logits: np.ndarray, now: float) -> None:
        self._logits = logits
        self.t_done = now
        self.missed = self.deadline is not None and now > self.deadline
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()


@dataclass
class FrontEndReport:
    """Aggregate view of one multi-tenant serving interval: totals, the
    fairness index, and one row per tenant (scalars only, so the JSON
    round-trip is exact)."""

    requests: int
    images: int
    wall_s: float
    images_per_s: float
    #: Jain's index over per-tenant delivered images/s divided by tenant
    #: weight — 1.0 means delivery tracked the weights exactly.
    fairness: float
    #: deadline promotions the schedulers performed (requests served
    #: out of DRR order because their slack went negative).
    promotions: int
    networks: Tuple[str, ...] = ()
    #: per-tenant rows: tenant/network/weight/deadline_ms/requests/
    #: images/images_per_s/p50_ms/p95_ms/p99_ms/deadline_misses/
    #: deadline_miss_rate/picks/served_cost
    tenant_rows: Tuple[Dict[str, Any], ...] = ()
    metrics: Dict[str, Any] = field(default_factory=dict)

    def table(self) -> str:
        head = [
            f"requests={self.requests}  images={self.images}  "
            f"wall={self.wall_s:.3f}s  "
            f"throughput={self.images_per_s:.1f} images/s",
            f"networks={','.join(self.networks)}  "
            f"fairness(Jain)={self.fairness:.3f}  "
            f"deadline promotions={self.promotions}",
        ]
        hdr = (f"{'tenant':>12s} {'network':>14s} {'w':>5s} {'reqs':>5s} "
               f"{'imgs':>6s} {'img/s':>8s} {'p50ms':>8s} {'p99ms':>8s} "
               f"{'miss':>6s}")
        rows = [hdr, "-" * len(hdr)]
        for r in self.tenant_rows:
            rows.append(
                f"{r['tenant']:>12s} {r['network']:>14s} "
                f"{r['weight']:>5.1f} {r['requests']:>5d} "
                f"{r['images']:>6d} {r['images_per_s']:>8.1f} "
                f"{r['p50_ms']:>8.2f} {r['p99_ms']:>8.2f} "
                f"{r['deadline_miss_rate']:>6.0%}")
        return "\n".join(head + rows)

    # -- serialization (same law as ServingReport) ---------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, **kw)

    @classmethod
    def from_json(cls, payload: Union[str, Dict[str, Any]]
                  ) -> "FrontEndReport":
        data = json.loads(payload) if isinstance(payload, str) \
            else dict(payload)
        return cls(**restore_tuple_fields(cls, data))


class _Lane:
    """Per-network scheduling lane: the tenant queues, the DRR
    scheduler over them, and the forward queue its collector drains."""

    def __init__(self, engine: Any, quantum: float):
        self.engine = engine
        self.sched = WeightedFairScheduler(quantum=quantum)
        self.queues: Dict[str, deque] = {}
        self.cond = threading.Condition()
        self.stopping = False
        self.forward_q: "queue.Queue" = queue.Queue()
        self.threads: List[threading.Thread] = []


class MultiTenantFrontEnd:
    """One admission front door over several running serving engines.

    ``engines`` maps network name to an (unstarted) serving engine —
    anything with the ``start/stop/submit(images) -> request`` surface
    of :class:`~repro_torch.runtime.cnn_serving.CnnServingEngine`.  The
    front-end owns engine lifecycle: :meth:`start` starts them,
    :meth:`stop` drains and stops them.

    Per network, one *scheduler* thread runs the weighted-fair pick
    loop over that network's tenant queues and forwards the chosen
    request to the engine (blocking on the engine's bounded queue —
    that block IS the backpressure that pools the backlog up here),
    and one *collector* thread awaits engine results in forward order,
    delivers them to the front-end handles, and keeps the per-tenant
    stats.  ``max_outstanding`` adds a front-end-wide
    :class:`AdmissionController` credit bound across all networks
    (acquired before forwarding, released at delivery).

    Use as a context manager, mirror of the engines themselves::

        with MultiTenantFrontEnd({"r18": cp18.serve(params)}) as fe:
            fe.register_tenant("alice", network="r18", weight=4.0)
            req = fe.submit("alice", images)
            logits = req.result()
    """

    def __init__(self, engines: Mapping[str, Any], *,
                 quantum: float = 1.0,
                 max_outstanding: Optional[int] = None,
                 tracer=None, metrics: Optional[MetricsRegistry] = None,
                 clock: Optional[Callable[[], float]] = None,
                 metric_window: int = METRIC_WINDOW):
        if not engines:
            raise ValueError("front-end needs at least one engine")
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.metrics = MetricsRegistry() if metrics is None else metrics
        if clock is None:
            clock = self.tracer.clock if self.tracer.enabled \
                else monotonic_clock
        self._clock = clock
        self.admission = AdmissionController(
            max_outstanding, name="frontend", clock=clock) \
            if max_outstanding is not None else None
        self._lanes: Dict[str, _Lane] = {
            net: _Lane(eng, quantum) for net, eng in engines.items()}
        self.tenants: Dict[str, TenantSpec] = {}
        self._lock = threading.Condition()
        self._rid = 0
        self._outstanding = 0
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self._started = False
        self._stopped = False
        self._accepting = False
        self._error: Optional[BaseException] = None
        # per-tenant delivery stats (under self._lock)
        self._lat: Dict[str, deque] = {}
        self._images: Dict[str, int] = {}
        self._requests: Dict[str, int] = {}
        self._done: Dict[str, int] = {}
        self._misses: Dict[str, int] = {}
        self._metric_window = metric_window

    # -- registration --------------------------------------------------------

    def register_tenant(self, name: str, *, network: str,
                        weight: float = 1.0,
                        deadline_ms: Optional[float] = None) -> TenantSpec:
        """Register ``name`` against ``network`` with a fair-share
        ``weight`` and an optional per-request ``deadline_ms``.  Must
        name a known network; tenant names are front-end-global."""
        if network not in self._lanes:
            raise ValueError(
                f"unknown network {network!r}; have "
                f"{sorted(self._lanes)}")
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already registered")
        spec = TenantSpec(name, network, float(weight), deadline_ms)
        lane = self._lanes[network]
        with lane.cond:
            lane.sched.register(name, spec.weight)
            lane.queues[name] = deque()
        with self._lock:
            self.tenants[name] = spec
            self._lat[name] = deque(maxlen=self._metric_window)
            self._images[name] = 0
            self._requests[name] = 0
            self._done[name] = 0
            self._misses[name] = 0
        return spec

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MultiTenantFrontEnd":
        if self._started:
            return self
        if self._stopped:
            raise RuntimeError("front-end is single-use; build a new one")
        started: List[Any] = []
        try:
            for lane in self._lanes.values():
                lane.engine.start()
                started.append(lane.engine)
        except BaseException:
            for eng in started:
                eng.stop()
            raise
        for net, lane in self._lanes.items():
            lane.threads = [
                threading.Thread(target=self._schedule_loop,
                                 args=(net, lane), daemon=True,
                                 name=f"frontend-sched-{net}"),
                threading.Thread(target=self._collect_loop,
                                 args=(net, lane), daemon=True,
                                 name=f"frontend-collect-{net}"),
            ]
            for t in lane.threads:
                t.start()
        self._started = True
        self._accepting = True
        return self

    def stop(self) -> None:
        """Drain every queued and in-flight request, stop the engines,
        and (when configured) verify the global admission tier is
        quiescent."""
        if not self._started:
            return
        self._accepting = False
        for lane in self._lanes.values():
            with lane.cond:
                lane.stopping = True
                lane.cond.notify_all()
        for lane in self._lanes.values():
            lane.threads[0].join()            # scheduler drained its queues
            lane.forward_q.put(_STOP)
            lane.threads[1].join()            # collector delivered the rest
            lane.engine.stop()
        self._started = False
        self._stopped = True
        if self._error is None and self.admission is not None:
            self.admission.assert_quiescent()

    def __enter__(self) -> "MultiTenantFrontEnd":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission ----------------------------------------------------------

    def submit(self, tenant: str, images) -> FrontEndRequest:
        """Enqueue ``images`` for ``tenant``; returns the front-end
        handle.  Thread-safe (one producer per tenant or many — the
        global admission invariants are asserted under exactly that)."""
        if not self._started:
            raise RuntimeError("front-end not started")
        if self._error is not None:
            raise RuntimeError("front-end failed") from self._error
        spec = self.tenants.get(tenant)
        if spec is None:
            raise ValueError(f"unknown tenant {tenant!r}")
        arr = np.asarray(images)
        if arr.ndim == 3:
            arr = arr[None]
        lane = self._lanes[spec.network]
        with self._lock:
            self._rid += 1
            req = FrontEndRequest(self._rid, tenant, spec.network, arr,
                                  self._clock(), spec.deadline_ms)
            self._outstanding += 1
            if self._t0 is None or req.t_submit < self._t0:
                self._t0 = req.t_submit
            self._requests[tenant] += 1
        if self.tracer.enabled:
            self.tracer.begin("request", f"tenant:{tenant}", req.rid,
                              images=req.n, network=spec.network)
        self.metrics.counter("frontend_requests_submitted",
                             tenant=tenant).inc()
        with lane.cond:
            if not self._accepting:
                with self._lock:
                    self._outstanding -= 1
                    self._requests[tenant] -= 1
                if self.tracer.enabled:
                    self.tracer.end("request", f"tenant:{tenant}", req.rid,
                                    rejected=True)
                raise RuntimeError("front-end is stopping")
            lane.queues[tenant].append(req)
            lane.cond.notify_all()
        return req

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted request has been delivered."""
        with self._lock:
            if not self._lock.wait_for(
                    lambda: self._outstanding == 0
                    or self._error is not None, timeout):
                raise TimeoutError(
                    f"{self._outstanding} request(s) still outstanding")
        if self._error is not None:
            raise RuntimeError("front-end failed") from self._error

    def serve(self, batches: Sequence[Tuple[str, Any]]
              ) -> Tuple[List[np.ndarray], FrontEndReport]:
        """Closed-loop convenience: submit every ``(tenant, images)``
        pair, drain, return ([logits per batch], report)."""
        reqs = [self.submit(t, b) for t, b in batches]
        self.drain()
        return [r.result() for r in reqs], self.report()

    # -- worker threads ------------------------------------------------------

    def _schedule_loop(self, net: str, lane: _Lane) -> None:
        try:
            while True:
                with lane.cond:
                    while True:
                        backlog = {
                            t: HeadOfQueue(cost=float(q[0].n),
                                           deadline=q[0].deadline)
                            for t, q in lane.queues.items() if q}
                        if backlog or lane.stopping:
                            break
                        lane.cond.wait()
                    if not backlog:
                        return                 # stopping and fully drained
                    tenant = lane.sched.pick(backlog, now=self._clock())
                    req = lane.queues[tenant].popleft()
                # forward OUTSIDE the lane lock: both the global credit
                # acquire and the engine's bounded queue may block, and
                # submit() must stay free to append meanwhile
                if self.admission is not None:
                    self.admission.acquire()
                req.t_forward = self._clock()
                try:
                    eng_req = lane.engine.submit(req.images)
                except BaseException as exc:
                    if self.admission is not None:
                        self.admission.release()
                    raise exc
                lane.forward_q.put((req, eng_req))
        except BaseException as exc:          # pragma: no cover - fatal path
            self._fail(exc, lane)

    def _collect_loop(self, net: str, lane: _Lane) -> None:
        try:
            while True:
                item = lane.forward_q.get()
                if item is _STOP:
                    return
                req, eng_req = item
                try:
                    logits = eng_req.result()
                except BaseException as exc:
                    # the engine-side request failed: fail THIS handle
                    # (its waiter must not hang), return the credit, then
                    # fall into the lane-wide failure path
                    req._fail(exc)
                    if self.admission is not None:
                        self.admission.release()
                    with self._lock:
                        self._outstanding -= 1
                        self._lock.notify_all()
                    raise exc
                if self.admission is not None:
                    self.admission.release()
                now = self._clock()
                req._deliver(logits, now)
                if self.tracer.enabled:
                    self.tracer.end("request", f"tenant:{req.tenant}",
                                    req.rid, images=req.n,
                                    missed=req.missed)
                self.metrics.counter("frontend_images_delivered",
                                     tenant=req.tenant).inc(req.n)
                if req.missed:
                    self.metrics.counter("frontend_deadline_missed",
                                         tenant=req.tenant).inc()
                with self._lock:
                    self._lat[req.tenant].append(req.latency_s)
                    self._images[req.tenant] += req.n
                    self._done[req.tenant] += 1
                    if req.missed:
                        self._misses[req.tenant] += 1
                    if self._t_last is None or now > self._t_last:
                        self._t_last = now
                    self._outstanding -= 1
                    self._lock.notify_all()
        except BaseException as exc:          # pragma: no cover - fatal path
            self._fail(exc, lane)

    def _fail(self, exc: BaseException, lane: _Lane) -> None:
        with self._lock:
            if self._error is None:
                self._error = exc
            self._lock.notify_all()
        with lane.cond:
            for q in lane.queues.values():
                while q:
                    q.popleft()._fail(exc)
            lane.stopping = True
            lane.cond.notify_all()
        # forwarded-but-undelivered handles must not strand their waiters
        while True:
            try:
                item = lane.forward_q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                item[0]._fail(exc)

    # -- reporting -----------------------------------------------------------

    def report(self) -> FrontEndReport:
        """Snapshot across every tenant.  Safe to call mid-run (the
        benchmark samples two snapshots to measure steady-state
        weighted shares)."""
        with self._lock:
            wall = (self._t_last - self._t0) \
                if (self._t0 is not None and self._t_last is not None) \
                else 0.0
            rows: List[Dict[str, Any]] = []
            shares: Dict[str, float] = {}
            total_req = 0
            total_img = 0
            for name, spec in sorted(self.tenants.items()):
                lane = self._lanes[spec.network]
                lat = sorted(self._lat[name])

                def pct(p: float) -> float:
                    if not lat:
                        return 0.0
                    return 1e3 * lat[max(0, math.ceil(p * len(lat)) - 1)]

                n_req = self._requests[name]
                n_img = self._images[name]
                rate = n_img / wall if wall > 0 else 0.0
                misses = self._misses[name]
                delivered = self._done[name]
                rows.append({
                    "tenant": name,
                    "network": spec.network,
                    "weight": spec.weight,
                    "deadline_ms": spec.deadline_ms,
                    "requests": n_req,
                    "images": n_img,
                    "images_per_s": rate,
                    "p50_ms": pct(0.50),
                    "p95_ms": pct(0.95),
                    "p99_ms": pct(0.99),
                    "deadline_misses": misses,
                    "deadline_miss_rate":
                        misses / delivered if delivered else 0.0,
                    "picks": lane.sched.picks.get(name, 0),
                    "served_cost": lane.sched.served_cost.get(name, 0.0),
                })
                total_req += n_req
                total_img += n_img
                if n_req:
                    shares[name] = rate / spec.weight
            return FrontEndReport(
                requests=total_req,
                images=total_img,
                wall_s=wall,
                images_per_s=total_img / wall if wall > 0 else 0.0,
                fairness=jain_fairness(shares),
                promotions=sum(l.sched.promotions
                               for l in self._lanes.values()),
                networks=tuple(sorted(self._lanes)),
                tenant_rows=tuple(rows),
                metrics=self.metrics.snapshot(),
            )
