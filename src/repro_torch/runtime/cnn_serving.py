"""Continuous-streaming CNN serving — H2PIPE's §V runtime, not one-shot.

The paper's accelerator never runs one image at a time: all layers
process concurrently on a continuous image stream, a new image admitted
every initiation interval, the number in flight bounded by FIFO credits
(§V-A).  ``PipelineExecutor.run()`` is the one-shot analogue; this
module is the *serving* analogue, built on executor re-entrancy and the
per-shape fused-trace cache (a CUDA graph per shape on the card):

:class:`CnnServingEngine`
    Owns a :class:`~repro_torch.compiler.pipeline.CompiledPipeline`, a
    bounded request queue, and two worker threads.  Requests of mixed
    image counts are *packed* into one fixed microbatch shape (pad +
    mask) so the per-shape fused-trace cache stays at a single warm
    entry, and dispatch is asynchronously double-buffered on a CUDA
    stream of the engine's own: the dispatcher copies microbatch ``t+1``
    to the card and enqueues its graph replay while ``t`` is in flight,
    recording an event after each; the completer waits on the event only
    at result delivery, copies the logits to the host and hands the
    credit back.  The §V-A credit bound
    (:class:`~repro_torch.core.admission.AdmissionController`, at most
    ``credits`` microbatches in flight) stands between the dispatcher
    and the device queue exactly where the paper's burst-matching FIFO
    credits stand between prefetcher and HBM.  Each in-flight credit
    packs into a pinned host buffer of its own, so no buffer is refilled
    before its asynchronous copy has finished.

:class:`ServingReport`
    What a serving interval did: throughput (images/s), p50/p95/p99
    request latency, queue depth over time, microbatch occupancy, and
    per-request Eq. 2 HBM words (useful words per request, plus the
    executed total including padding — the padding overhead is visible,
    never silently folded in).

Requests and results are numpy arrays at the host boundary.  Results
are bit-identical to sequential ``run()`` per request: packing only
concatenates images along the batch dimension, every engine is
per-image, and padded rows are sliced away before delivery (held against
the JAX package in tests/test_torch_cnn_serving.py, including under
concurrent producers).  The engine runs on the card unless given
``device="cpu"``; its params must live on that device.
"""
from __future__ import annotations

import dataclasses
import json
import math
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.core import fifo_sim
from repro_torch.core.admission import AdmissionController, AdmissionError
from repro_torch.models.cnn import cnn_input_shape
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.stall import stall_attribution
from repro_torch.obs.trace import NULL_TRACER, monotonic_clock
from repro_torch.runtime.pipeline import resolve_device

__all__ = ["CnnRequest", "CnnServingEngine", "MicrobatchPacker",
           "ServingReport", "restore_tuple_fields"]

_STOP = object()                      # request-queue shutdown sentinel

# a long-lived server must not grow without bound: per-request metrics
# keep the most recent window (percentiles/rows are over this window;
# the throughput counters are exact lifetime totals)
METRIC_WINDOW = 16384
REQUEST_ROW_WINDOW = 1024


class CnnRequest:
    """One submitted inference request: ``n`` images in, ``n`` logits
    rows out.  Rows may span microbatches; the result is visible only
    once every row has been delivered."""

    def __init__(self, rid: int, images: np.ndarray,
                 now: Optional[float] = None):
        self.rid = rid
        self.images = images
        self.n = int(images.shape[0])
        # the submitting engine passes its injected clock's reading; the
        # bare-constructor default keeps direct (test) construction easy
        self.t_submit = time.perf_counter() if now is None else now
        self.t_done: Optional[float] = None
        self.hbm_words = 0            # useful Eq. 2 words (n * words/image)
        self._logits: Optional[np.ndarray] = None
        self._remaining = self.n
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
        """Block until delivered; returns logits [n, classes]."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done in {timeout}s")
        if self._error is not None:
            raise RuntimeError(
                f"request {self.rid} failed in the serving engine"
            ) from self._error
        return self._logits

    # called only from the completer thread (single consumer)
    def _deliver(self, row_offset: int, rows: np.ndarray, now: float) -> bool:
        if self._logits is None:
            self._logits = np.empty((self.n,) + rows.shape[1:], rows.dtype)
        self._logits[row_offset:row_offset + len(rows)] = rows
        self._remaining -= len(rows)
        if self._remaining == 0:
            self.t_done = now
            self._event.set()
            return True
        return False

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()


class MicrobatchPacker:
    """Greedy pad+mask packing over one bounded request queue: fill a
    fixed ``microbatch`` shape from whatever rows are available, rows
    spanning microbatch boundaries via the (request, offset) cursor,
    never waiting for more once at least one row is held (latency over
    occupancy — the padding keeps partial batches exact, just less
    dense).  Owned by ONE consumer thread.
    """

    def __init__(self, request_queue: "queue.Queue", microbatch: int):
        self.queue = request_queue
        self.microbatch = microbatch
        self.cursor: Optional[List[Any]] = None      # [request, row_offset]
        self.saw_stop = False

    def collect(self, *, block: bool = True):
        """One packed microbatch: ``(rows, filled)`` with ``rows`` a
        list of ``(request, req_offset, mb_offset, take)`` spans, or
        ``None`` when nothing is available (queue empty and
        ``block=False``, or the stop sentinel was drained)."""
        rows: List[Tuple[CnnRequest, int, int, int]] = []
        filled = 0
        while filled < self.microbatch:
            if self.cursor is None:
                if self.saw_stop:
                    break
                try:
                    item = self.queue.get(block=block and filled == 0)
                except queue.Empty:
                    break
                if item is _STOP:
                    self.saw_stop = True
                    break
                self.cursor = [item, 0]
            req, off = self.cursor
            take = min(req.n - off, self.microbatch - filled)
            rows.append((req, off, filled, take))
            filled += take
            self.cursor = [req, off + take] if off + take < req.n else None
        if filled == 0:
            return None                              # stopped and empty
        return rows, filled

    @property
    def depth_hint(self) -> int:
        """Approximate queued depth (requests + the partially consumed
        cursor) for the report's queue-depth samples."""
        return self.queue.qsize() + (1 if self.cursor else 0)

    def fail_cursor(self, exc: BaseException) -> None:
        """Fail the partially consumed request, if any."""
        if self.cursor is not None:
            self.cursor[0]._fail(exc)
            self.cursor = None


def _deep_tuple(value: Any) -> Any:
    """Recursively convert lists to tuples (JSON has no tuples, report
    fields may nest them — per-stage rows of per-shard pairs)."""
    if isinstance(value, list):
        return tuple(_deep_tuple(v) for v in value)
    return value


def restore_tuple_fields(cls, payload: Dict[str, Any]) -> Dict[str, Any]:
    """The report deserialization law shared by every report dataclass:
    drop unknown keys (derived values ride in the dict but are never
    constructor args) and restore tuple-typed fields from JSON's lists —
    *recursively*, so nested rows round-trip to equality rather than
    silently decaying to lists one level down."""
    names = {f.name for f in dataclasses.fields(cls)}
    data = {k: v for k, v in payload.items() if k in names}
    for f in dataclasses.fields(cls):
        # annotations may be strings (``from __future__ import
        # annotations``) or live typing objects — match both spellings
        if f.name in data and str(f.type).startswith(
                ("Tuple", "typing.Tuple", "tuple")):
            data[f.name] = _deep_tuple(data[f.name])
    return data


@dataclass
class ServingReport:
    """Aggregate view of one serving interval (see module docstring)."""

    requests: int
    images: int
    microbatches: int
    microbatch_size: int
    padded_rows: int
    credits: int
    max_in_flight: int
    wall_s: float
    images_per_s: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    hbm_words_per_image: int
    hbm_words_useful: int             # sum over requests of n * words/image
    hbm_words_executed: int           # traced words incl. padded rows
    queue_depth: List[Tuple[float, int]] = field(default_factory=list)
    request_rows: List[Dict[str, Any]] = field(default_factory=list)
    #: total rows dispatched including padding — equals
    #: ``microbatches * microbatch_size`` under the fixed packed shape,
    #: less under adaptive sizing (small packs dispatch small shapes).
    #: 0 on reports from engines predating the field (fixed-shape
    #: fallback applies).
    dispatched_rows: int = 0
    #: adaptive-sizing evidence: packed-shape row count -> dispatches
    #: (one ``{str(rows): count}`` entry per ladder rung used).  Empty
    #: for fixed-shape engines.
    microbatch_shapes: Dict[str, int] = field(default_factory=dict)
    #: stage-6 LRU trace cache counters (entries/max_entries/hits/misses/
    #: evictions) from ``CompiledPipeline.trace_cache_stats()`` — whether
    #: the serving interval's shape population thrashes the trace bound.
    trace_cache: Dict[str, int] = field(default_factory=dict)
    #: the engine-local :class:`~repro_torch.obs.metrics.MetricsRegistry`
    #: snapshot at report time (counters/gauges/histograms).
    metrics: Dict[str, Any] = field(default_factory=dict)
    #: measured admission-wait / dispatch-gap fractions laid against the
    #: ``fifo_sim`` modelled stall cycles
    #: (:func:`repro_torch.obs.stall.stall_attribution`) — the measured half
    #: of the §VI bandwidth-efficiency reproduction.
    bandwidth_efficiency: Dict[str, Any] = field(default_factory=dict)

    @property
    def pad_fraction(self) -> float:
        total = self.dispatched_rows \
            or self.microbatches * self.microbatch_size
        return self.padded_rows / total if total else 0.0

    @property
    def effective_images_per_s(self) -> float:
        """Dispatch-side throughput discounted by padding: the rate
        microbatch rows left the dispatcher, weighted by the fraction
        that carried real images — what the pipeline would sustain on
        perfectly packed input, collapsed to what it delivered."""
        if self.wall_s <= 0:
            return 0.0
        total = self.dispatched_rows \
            or self.microbatches * self.microbatch_size
        return (total / self.wall_s) * (1.0 - self.pad_fraction)

    def table(self) -> str:
        """Human-readable summary + per-request rows."""
        head = [
            f"requests={self.requests}  images={self.images}  "
            f"microbatches={self.microbatches}x{self.microbatch_size} "
            f"(pad {self.pad_fraction:.0%})  "
            f"in-flight<= {self.max_in_flight}/{self.credits}",
            f"throughput={self.images_per_s:.1f} images/s  "
            f"effective={self.effective_images_per_s:.1f} images/s "
            f"(pad-fraction-weighted)  "
            f"latency p50={self.p50_ms:.1f}ms p95={self.p95_ms:.1f}ms "
            f"p99={self.p99_ms:.1f}ms",
            f"Eq.2 words/image={self.hbm_words_per_image}  "
            f"useful={self.hbm_words_useful}  "
            f"executed={self.hbm_words_executed} (incl. padding)",
        ]
        if len(self.microbatch_shapes) > 1:
            shapes = "  ".join(f"{k}x{v}" for k, v in
                               self.microbatch_shapes.items())
            head.append(f"adaptive shapes (rows x dispatches): {shapes}")
        if self.trace_cache:
            tc = self.trace_cache
            head.append(
                f"trace cache: {tc.get('entries', 0)}/"
                f"{tc.get('max_entries', 0)} entries  "
                f"hits={tc.get('hits', 0)} misses={tc.get('misses', 0)} "
                f"evictions={tc.get('evictions', 0)}")
        be = self.bandwidth_efficiency
        if be:
            m = be.get("measured", {})
            line = (f"stalls: admission-wait "
                    f"{m.get('admission_wait_fraction', 0.0):.1%}  "
                    f"dispatch-gap "
                    f"{m.get('dispatch_gap_fraction', 0.0):.1%}")
            mo = be.get("modelled")
            if mo:
                line += (f"  modelled {mo.get('stall_fraction', 0.0):.1%} "
                         f"({mo.get('stall_cycles', 0)}/"
                         f"{mo.get('cycles', 0)} cycles)")
            head.append(line)
        hdr = f"{'rid':>5s} {'images':>6s} {'latency_ms':>10s} " \
              f"{'hbm_words':>10s}"
        rows = [hdr, "-" * len(hdr)]
        for r in self.request_rows:
            rows.append(f"{r['rid']:>5d} {r['images']:>6d} "
                        f"{r['latency_ms']:>10.2f} {r['hbm_words']:>10d}")
        return "\n".join(head + rows)

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe dict of every field plus the derived rates
        (``pad_fraction``, ``effective_images_per_s``) — the same schema
        as the JAX package's report, so either package reads the
        other's."""
        out = dataclasses.asdict(self)
        out["queue_depth"] = [list(q) for q in self.queue_depth]
        out["pad_fraction"] = self.pad_fraction
        out["effective_images_per_s"] = self.effective_images_per_s
        return out

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, **kw)

    @classmethod
    def from_json(cls, payload: Union[str, Dict[str, Any]]
                  ) -> "ServingReport":
        """Round-trip inverse of :meth:`to_json`/:meth:`to_dict`:
        ``cls.from_json(rep.to_json()) == rep`` (derived keys are
        recomputed, JSON's lists restored to the tuple-shaped fields —
        recursively, so nested row tuples survive)."""
        data = json.loads(payload) if isinstance(payload, str) \
            else dict(payload)
        data = restore_tuple_fields(cls, data)
        data["queue_depth"] = [tuple(q) for q in
                               data.get("queue_depth", [])]
        return cls(**data)


class ServingObsMixin:
    """The observability surface of the serving engine: lazy
    ``fifo_sim`` modelled stalls, the measured-vs-modelled
    ``bandwidth_efficiency`` section, and the metrics snapshot with
    trace-cache gauges.  Expects ``self.compiled`` / ``self.admission`` /
    ``self.metrics`` / ``self._gap_s``."""

    def _modelled_stalls(self):
        """The deterministic ``fifo_sim`` side of stall attribution,
        computed once per engine (plans that stream nothing model as
        ``None``): ``(outcome, streamed engine names, word_scale)``."""
        if self._modelled is False:
            plan = self.compiled.plan
            try:
                sim_cfg, scale = plan.sim_config()
                outcome = fifo_sim.simulate(sim_cfg, "credit")
                names = tuple(s.spec.name for s in plan.streamed
                              if s.weight_words_per_row > 0)
                self._modelled = (outcome, names, scale)
            except ValueError:
                self._modelled = None
        return self._modelled

    def _stall_report(self, wall: float) -> Dict[str, Any]:
        modelled = self._modelled_stalls()
        outcome, names, scale = modelled if modelled else (None, (), None)
        return stall_attribution(
            wall_s=wall,
            admission_wait_s=self.admission.wait_seconds_total,
            dispatch_gap_s=self._gap_s,
            modelled=outcome, engine_names=names, word_scale=scale)

    def _metrics_snapshot(self) -> Dict[str, Any]:
        """Engine registry snapshot with the trace-cache counters set as
        gauges at read time (the cache lives on the pipeline; the
        gauges make it part of THIS engine's metrics view)."""
        for k, v in self.compiled.trace_cache_stats().items():
            self.metrics.gauge("trace_cache", counter=k).set(v)
        self.metrics.gauge("admission_wait_seconds_total").set(
            self.admission.wait_seconds_total)
        self.metrics.gauge("dispatch_gap_seconds_total").set(self._gap_s)
        return self.metrics.snapshot()


class CnnServingEngine(ServingObsMixin):
    """Credit-bounded, double-buffered serving over one compiled pipeline.

    ``credits`` is the §V-A in-flight bound: at most that many
    microbatches between dispatch and delivery.
    ``microbatch`` is the one packed shape every dispatch uses, so the
    fused-trace cache holds exactly one warm entry however mixed the
    request sizes are.

    ``adaptive=True`` trades that single warm entry for latency under
    light load: each dispatch packs into the smallest rung of
    ``microbatch_ladder`` (default: powers of two up to ``microbatch``)
    that holds the rows actually collected, so a shallow queue dispatches
    small low-padding shapes and a deep queue grows back to the full
    ``microbatch``.  The ladder must fit the pipeline's bounded
    trace-cache LRU (``trace_cache_size``) so every rung stays warm —
    validated at construction, and the shapes actually used are surfaced
    as ``ServingReport.microbatch_shapes``.

    Use as a context manager (``with cp.serve(params) as eng``) or call
    :meth:`start`/:meth:`stop` explicitly; :meth:`submit` is thread-safe
    (N producers may submit concurrently — the admission invariants are
    asserted under exactly that in the stress test).
    """

    def __init__(self, compiled, params, *, microbatch: int = 8,
                 credits: int = 4, queue_depth: int = 64,
                 device="cuda", act_scale: float = 0.05,
                 adaptive: bool = False,
                 microbatch_ladder: Optional[Sequence[int]] = None,
                 tracer=None, metrics: Optional[MetricsRegistry] = None,
                 clock: Optional[Callable[[], float]] = None,
                 metric_window: int = METRIC_WINDOW,
                 request_row_window: int = REQUEST_ROW_WINDOW):
        if microbatch <= 0:
            raise ValueError("microbatch must be positive")
        self.compiled = compiled
        self.params = params
        self.microbatch = microbatch
        self.act_scale = act_scale
        if microbatch_ladder is not None:
            adaptive = True
        if adaptive:
            if microbatch_ladder is None:
                # powers of two up to the full shape (always included)
                microbatch_ladder = sorted(
                    {min(1 << i, microbatch)
                     for i in range(microbatch.bit_length())}
                    | {microbatch})
            ladder = sorted(set(int(r) for r in microbatch_ladder))
            if not ladder or ladder[0] < 1 or ladder[-1] != microbatch:
                raise ValueError(
                    f"microbatch_ladder must be positive sizes topping "
                    f"out at microbatch={microbatch}, got {ladder}")
            if len(ladder) > compiled.trace_cache_size:
                raise ValueError(
                    f"microbatch_ladder has {len(ladder)} rungs but the "
                    f"trace cache holds {compiled.trace_cache_size} — "
                    f"the ladder would thrash its own traces")
            self.microbatch_ladder: Tuple[int, ...] = tuple(ladder)
        else:
            self.microbatch_ladder = (microbatch,)
        self.adaptive = adaptive
        self.device = resolve_device(device)
        # observability: no-op tracer unless one is injected; an
        # engine-local metrics registry; ONE clock shared by requests,
        # the tracer, and the admission controller (so a fake clock
        # makes every latency/percentile path deterministic)
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.metrics = MetricsRegistry() if metrics is None else metrics
        if clock is None:
            clock = self.tracer.clock if self.tracer.enabled \
                else monotonic_clock
        self._clock = clock
        self.admission = AdmissionController(credits, name="cnn-serving",
                                             clock=clock)
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._inflight: "queue.Queue" = queue.Queue()
        self._in_shape = cnn_input_shape(compiled.plan.cfg, microbatch)
        #: analytic Eq. 2 words per image (plan-side; start() cross-checks
        #: the fused trace's executed counters against it)
        self.words_per_image = sum(
            compiled.plan.hbm_words_per_image().values())
        self._trace = None
        # the dispatcher's and the completer's CUDA streams, and one
        # pinned host buffer per credit, plus one: a buffer is refilled
        # only after its copy to the card has finished (its event), never
        # while it is in flight
        self._stream = self._copy_stream = None
        self._staging: List[Tuple[torch.Tensor, Any]] = []
        self._slot = 0
        self._packer = MicrobatchPacker(self._queue, microbatch)
        self._threads: List[threading.Thread] = []
        self._started = False
        self._stopped = False
        self._error: Optional[BaseException] = None

        self._lock = threading.Condition()
        # serializes submissions against shutdown: stop() flips
        # _accepting and enqueues the sentinel under this lock, so no
        # submit() can land a request behind the sentinel unseen
        self._submit_lock = threading.Lock()
        self._accepting = False
        self._rid = 0
        self._outstanding = 0
        self._latencies: deque = deque(maxlen=metric_window)
        self._request_rows: deque = deque(maxlen=request_row_window)
        self._images_done = 0
        self._requests_done = 0
        self._mb_count = 0
        self._padded_rows = 0
        self._dispatched_rows = 0
        self._shape_counts: Dict[int, int] = {}
        self._rung_traces: Dict[int, Any] = {}
        self._depth_samples: deque = deque(maxlen=metric_window)
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        # stall attribution: dispatcher time spent with nothing to pack
        # (between dispatches) — admission waits live on the controller
        self._gap_s = 0.0
        self._modelled = False        # False = not yet computed (lazy)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "CnnServingEngine":
        if self._started:
            return self
        if self._stopped:
            raise RuntimeError(
                "serving engine is single-use; create a new one "
                "(CompiledPipeline.serve) instead of restarting")
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._copy_stream = torch.cuda.Stream(self.device)
            self._staging = [
                (torch.zeros(self._in_shape, dtype=torch.int8,
                             pin_memory=True), torch.cuda.Event())
                for _ in range(self.admission.capacity + 1)]
        # warm the ONE fused trace every microbatch reuses (and read the
        # per-image Eq. 2 words off its stats template)
        self._trace = self._trace_for(self.microbatch)
        self._threads = [
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name="cnn-serving-dispatch"),
            threading.Thread(target=self._complete_loop, daemon=True,
                             name="cnn-serving-complete"),
        ]
        for t in self._threads:
            t.start()
        self._started = True
        self._accepting = True
        return self

    def stop(self) -> None:
        """Drain everything already submitted, then shut the workers
        down and verify the admission accounting is quiescent.  The
        engine is single-use: a stopped engine cannot be restarted."""
        if not self._started:
            return
        # under the submit lock: once _accepting flips, no submit() can
        # enqueue, and everything enqueued earlier sits BEFORE the
        # sentinel — the dispatcher drains it all, nothing is orphaned
        with self._submit_lock:
            self._accepting = False
            self._queue.put(_STOP)
        for t in self._threads:
            t.join()
        self._started = False
        self._stopped = True
        if self._error is None:
            self.admission.assert_quiescent()

    def __enter__(self) -> "CnnServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission ----------------------------------------------------------

    def submit(self, images) -> CnnRequest:
        """Enqueue ``images`` ([n,H,W,C] int8, any n >= 1); returns the
        request handle.  Blocks when the bounded queue is full (the
        outer backpressure tier above the microbatch credits)."""
        if not self._started:
            raise RuntimeError("serving engine not started")
        if self._error is not None:
            raise RuntimeError("serving engine failed") from self._error
        arr = np.asarray(images)
        if arr.ndim == 3:
            arr = arr[None]
        want = self._in_shape[1:]
        if arr.ndim != 4 or arr.shape[1:] != want or arr.shape[0] < 1:
            raise ValueError(
                f"expected images [n,{want[0]},{want[1]},{want[2]}], "
                f"got {arr.shape}")
        arr = arr.astype(np.int8, copy=False)
        with self._lock:
            self._rid += 1
            req = CnnRequest(self._rid, arr, now=self._clock())
            req.hbm_words = req.n * self.words_per_image
            self._outstanding += 1
        if self.tracer.enabled:
            self.tracer.begin("request", "request", req.rid, images=req.n)
        # check-and-enqueue is atomic against stop()'s sentinel, so a
        # racing shutdown either rejects this request or dispatches it —
        # it can never strand it behind the sentinel.  The put is
        # bounded (never parked forever on a full queue whose workers
        # died), and an engine failure racing past the check is caught
        # by the post-put sweep — the request fails, it does not hang.
        with self._submit_lock:
            while True:
                if not self._accepting:
                    self._reject(req)
                    raise RuntimeError("serving engine is stopping")
                try:
                    self._queue.put(req, timeout=0.5)
                    break
                except queue.Full:
                    continue
        # the serving interval starts at the first request that actually
        # ENTERED the queue, and only enqueued requests count as
        # submitted — a submit() that lost the race against stop() is
        # rejected above and must skew neither wall_s nor the counter
        self._count_submitted(req)
        if self._error is not None:
            self._sweep_queues(self._error)
        return req

    def _count_submitted(self, req: CnnRequest) -> None:
        with self._lock:
            if self._t0 is None or req.t_submit < self._t0:
                self._t0 = req.t_submit
        self.metrics.counter("serving_requests_submitted").inc()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted request has been delivered."""
        with self._lock:
            if not self._lock.wait_for(
                    lambda: self._outstanding == 0 or self._error is not None,
                    timeout):
                raise TimeoutError(
                    f"{self._outstanding} request(s) still outstanding")
        if self._error is not None:
            raise RuntimeError("serving engine failed") from self._error

    def serve(self, batches: Sequence[Any]
              ) -> Tuple[List[np.ndarray], ServingReport]:
        """Closed-loop convenience: submit all ``batches``, drain, and
        return ([logits per batch], report)."""
        reqs = [self.submit(b) for b in batches]
        self.drain()
        return [r.result() for r in reqs], self.report()

    # -- reporting -----------------------------------------------------------

    def report(self) -> ServingReport:
        metrics = self._metrics_snapshot()
        with self._lock:
            lat = sorted(self._latencies)       # most recent metric window
            n_req = self._requests_done         # exact lifetime counter
            wall = (self._t_last - self._t0) \
                if (self._t0 is not None and self._t_last is not None) else 0.0
            mb = self._mb_count
            images = self._images_done

            def pct(p: float) -> float:
                if not lat:
                    return 0.0
                # nearest-rank: ceil(p*n)-th smallest (1-indexed)
                return 1e3 * lat[max(0, math.ceil(p * len(lat)) - 1)]

            return ServingReport(
                requests=n_req,
                images=images,
                microbatches=mb,
                microbatch_size=self.microbatch,
                padded_rows=self._padded_rows,
                credits=self.admission.capacity,
                max_in_flight=self.admission.max_in_flight_seen,
                wall_s=wall,
                images_per_s=images / wall if wall > 0 else 0.0,
                p50_ms=pct(0.50), p95_ms=pct(0.95), p99_ms=pct(0.99),
                hbm_words_per_image=self.words_per_image,
                hbm_words_useful=images * self.words_per_image,
                hbm_words_executed=self._dispatched_rows
                * self.words_per_image,
                queue_depth=list(self._depth_samples),
                request_rows=list(self._request_rows),
                dispatched_rows=self._dispatched_rows,
                microbatch_shapes={str(k): v for k, v in
                                   sorted(self._shape_counts.items())},
                trace_cache=self.compiled.trace_cache_stats(),
                metrics=metrics,
                bandwidth_efficiency=self._stall_report(wall),
            )

    # -- worker threads ------------------------------------------------------

    def _dispatch_loop(self) -> None:
        try:
            while True:
                # dispatch-gap attribution: time between finishing one
                # dispatch and holding the next pack is supply starvation
                # (queue empty), counted only once serving has begun —
                # the wait for the FIRST request is not a pipeline stall
                t_idle = self._clock()
                pack = self._collect_pack()
                if self._mb_count > 0:
                    self._gap_s += self._clock() - t_idle
                if pack is None:
                    break
                self._dispatch(*pack)
        except BaseException as exc:                 # pragma: no cover
            self._fail(exc)
        finally:
            self._inflight.put(None)                 # completer sentinel

    def _collect_pack(self):
        """One packed microbatch off the host queue (the shared
        :class:`MicrobatchPacker` greedy pad+mask policy)."""
        if self.tracer.enabled:
            with self.tracer.span("pack", "pack"):
                return self._packer.collect()
        return self._packer.collect()

    def _rung_for(self, filled: int) -> int:
        """Smallest ladder rung holding ``filled`` rows (the adaptive
        grow/shrink policy: shape follows what the queue supplied)."""
        for rung in self.microbatch_ladder:
            if rung >= filled:
                return rung
        return self.microbatch

    def _trace_for(self, rung: int):
        """The fused trace for a ladder rung, Eq. 2-checked on first use
        (the pipeline's bounded LRU holds the capture; this dict just
        skips the cache probe and re-verification on the hot path).  A
        rung first used mid-serve is captured here, on the dispatcher
        thread, while the completer may be copying results."""
        got = self._rung_traces.get(rung)
        if got is None:
            zeros = torch.zeros((rung,) + self._in_shape[1:],
                                dtype=torch.int8, device=self.device)
            got = self.compiled.fused_trace(self.params, zeros,
                                            act_scale=self.act_scale)
            traced = sum(st.hbm_words for st in got.stats)
            if traced != self.words_per_image * rung:
                raise RuntimeError(
                    f"traced Eq. 2 words ({traced}) disagree with the "
                    f"plan ({self.words_per_image} words/image x {rung})")
            self._rung_traces[rung] = got
        return got

    def _dispatch(self, rows, filled: int) -> None:
        tracer = self.tracer
        # padded packed shape: the one fixed microbatch, or (adaptive)
        # the smallest warm ladder rung the collected rows fit in
        shape_rows = self._rung_for(filled) if self.adaptive \
            else self.microbatch
        trace = self._trace if shape_rows == self.microbatch \
            else self._trace_for(shape_rows)
        if self._stream is None:
            staged, copied = torch.zeros(
                (shape_rows,) + self._in_shape[1:], dtype=torch.int8), None
        else:
            staged, copied = self._staging[self._slot]
            self._slot = (self._slot + 1) % len(self._staging)
            copied.synchronize()             # its last copy has finished
            staged = staged[:shape_rows]
            staged[filled:] = 0
        buf = staged.numpy()
        for req, roff, moff, take in rows:
            buf[moff:moff + take] = req.images[roff:roff + take]
        # the §V-A credit: at most ``credits`` microbatches between here
        # and delivery — blocks the dispatcher, never the device
        # (admission.wait_seconds_total accrues the blocked time)
        if tracer.enabled:
            with tracer.span("credit_wait", "admission"):
                ok = self.admission.acquire()
        else:
            ok = self.admission.acquire()
        if not ok:
            raise AdmissionError("admission controller closed mid-serve")
        if tracer.enabled:
            with tracer.span("dispatch", "dispatch", filled=filled,
                             shape_rows=shape_rows):
                logits, done = self._launch(trace, staged, copied)
        else:
            logits, done = self._launch(trace, staged, copied)
        t = self._clock()
        with self._lock:
            self._mb_count += 1
            seq = self._mb_count
            self._padded_rows += shape_rows - filled
            self._dispatched_rows += shape_rows
            self._shape_counts[shape_rows] = \
                self._shape_counts.get(shape_rows, 0) + 1
            depth = self._packer.depth_hint
            # rebase on `is not None`: an injected clock legitimately
            # starts at 0.0, and 0.0 is falsy — truthiness here silently
            # broke the first engine's sample timestamps
            self._depth_samples.append(
                (t - self._t0 if self._t0 is not None else 0.0, depth))
        if tracer.enabled:
            tracer.begin("microbatch", "in_flight", seq, filled=filled)
            tracer.counter("queue_depth", depth)
        self.metrics.counter("serving_microbatches").inc()
        self.metrics.counter("serving_padded_rows").inc(
            shape_rows - filled)
        self.metrics.gauge("serving_queue_depth").set(depth)
        self._inflight.put((logits, rows, seq, done))

    def _launch(self, trace, staged: torch.Tensor, copied):
        """One microbatch to the device: on the card, on the dispatcher's
        stream, the copy of the pinned buffer (its event recorded), the
        replay, the clone of the logits and the event the completer waits
        on; on the CPU the eager walk.  Returns (logits, event or None)."""
        if self._stream is None:
            return trace.fn(self.params, staged), None
        with torch.cuda.stream(self._stream):
            x = staged.to(self.device, non_blocking=True)
            copied.record(self._stream)
            logits = trace.fn(self.params, x)
            done = torch.cuda.Event()
            done.record(self._stream)
        return logits, done

    def _complete_loop(self) -> None:
        try:
            while True:
                item = self._inflight.get()
                if item is None:
                    break
                logits, rows, seq, done = item
                if done is None:
                    arr = logits.numpy()
                else:
                    done.synchronize()
                    with torch.cuda.stream(self._copy_stream):
                        arr = logits.cpu().numpy()
                self.admission.release()             # credit back on arrival
                now = self._clock()
                if self.tracer.enabled:
                    self.tracer.end("microbatch", "in_flight", seq)
                finished: List[CnnRequest] = []
                if self.tracer.enabled:
                    with self.tracer.span("deliver", "delivery", seq=seq):
                        for req, roff, moff, take in rows:
                            if req._deliver(roff, arr[moff:moff + take],
                                            now):
                                finished.append(req)
                else:
                    for req, roff, moff, take in rows:
                        if req._deliver(roff, arr[moff:moff + take], now):
                            finished.append(req)
                if finished:
                    lat_hist = self.metrics.histogram("serving_latency_ms")
                    with self._lock:
                        for req in finished:
                            self._latencies.append(req.latency_s)
                            self._images_done += req.n
                            self._requests_done += 1
                            self._request_rows.append({
                                "rid": req.rid, "images": req.n,
                                "latency_ms": 1e3 * req.latency_s,
                                "hbm_words": req.hbm_words,
                            })
                        self._t_last = now
                        self._outstanding -= len(finished)
                        self._lock.notify_all()
                    for req in finished:
                        lat_hist.observe(1e3 * req.latency_s)
                        self.metrics.counter("serving_requests_done").inc()
                        self.metrics.counter(
                            "serving_images_done").inc(req.n)
                        if self.tracer.enabled:
                            self.tracer.end("request", "request", req.rid)
        except BaseException as exc:                 # pragma: no cover
            self._fail(exc)

    def _reject(self, req: CnnRequest) -> None:
        """Back out a request that never entered the queue: the
        outstanding count reverts, and because ``_t0`` / the submitted
        counter are only advanced post-enqueue (:meth:`_count_submitted`)
        there is nothing else to unwind — a rejected request leaves
        ``wall_s`` and ``serving_requests_submitted`` untouched.  The
        request's trace span is closed so the export stays matched."""
        with self._lock:
            self._outstanding -= 1
            self._lock.notify_all()
        if self.tracer.enabled:
            self.tracer.end("request", "request", req.rid, rejected=True)

    def _fail(self, exc: BaseException) -> None:
        """Fail every queued and in-flight request, wake all waiters."""
        self._accepting = False        # flag only: no _submit_lock here (a
        # producer may hold it blocked in put() with no dispatcher left)
        with self._lock:
            if self._error is None:
                self._error = exc
            self._lock.notify_all()
        self.admission.close()
        self._sweep_queues(exc)
        self._packer.fail_cursor(exc)

    def _sweep_queues(self, exc: BaseException) -> None:
        """Fail everything sitting in the queues.  Safe to call from any
        thread, repeatedly: each item is retrieved exactly once (also run
        from submit() after a failure races its enqueue, so no request
        can land post-sweep and hang)."""
        for q in (self._queue, self._inflight):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if isinstance(item, CnnRequest):
                    item._fail(exc)
                elif isinstance(item, tuple):
                    for req, *_ in item[1]:
                        req._fail(exc)
                else:
                    # a shutdown sentinel (_STOP / completer None): a
                    # parked worker still needs it to exit — put it back
                    # and stop sweeping (nothing can land behind a
                    # sentinel: submissions are lock-serialized)
                    q.put(item)
                    break
