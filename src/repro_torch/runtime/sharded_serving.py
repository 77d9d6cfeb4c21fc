"""Sharded dataflow serving — the stage-pipelined runtime.

H2PIPE's die pipelines every layer engine concurrently, each fed by its
own HBM pseudo-channels; the distribution-level analogue runs the SAME
compiled schedule as a pipeline of stages over the slots of a mesh axis.
The compiler cuts the placed layer order into balanced stage programs
(:meth:`CompiledPipeline.partition`), and this engine executes them:

  * **stage ring**: one stage per slot of the ``axis`` (a slot may
    repeat a device: on one card every stage gets its own CUDA stream,
    so S stage programs run at once on one die).  Each stage is its
    slice of the compiled engine table captured as ONE CUDA graph at
    :meth:`start` (``trace_fused(..., layer_range=...)``, the port's
    counterpart of jitting the JAX engine's round); a round of M
    microbatches runs through
    :class:`~repro_torch.core.dataflow.StageRing` in M + S - 1 ticks,
    activations handed from stage to stage under the §V-A rule that a
    slot is reused only once consumed;
  * **shard-local producers**: ``submit(images, shard=...)`` feeds one
    of S bounded shard queues (round-robin by default) — each shard
    packs its own microbatches with the SAME
    :class:`~repro_torch.runtime.cnn_serving.MicrobatchPacker` the
    single-engine server uses, and the dispatcher drains shards fairly
    into rounds;
  * **cross-stage credits**: the §V-A in-flight bound is the shared
    :class:`~repro_torch.core.admission.AdmissionController` — unchanged
    — counting dispatched-not-delivered microbatches across the whole
    mesh (``credits >= round_microbatches`` so a full round fits; ``2x``
    double-buffers rounds);
  * **per-stage Eq. 2**: :meth:`start` hard-fails unless every stage's
    ``ExecutionReport.verify()`` passes on the partitioned plan AND the
    executed per-stage word counters collected while each stage graph
    was captured equal the stage plans.

The engine holds its stage graphs itself: they never enter the
pipeline's trace cache, so no eviction there can free a graph a live
ring replays, and the report's ``trace_cache`` reads that cache as the
JAX engine's does.  Params: at :meth:`start` every distinct device of
the mesh gets the tensors its stages read, copied once and held by the
engine (on one card no copy at all).  Short rounds run their empty
slots as zeros, as the JAX engine does, so ``hbm_words_executed``,
``dispatched_rows`` and ``empty_microbatches`` mean the same in both
packages.  A failed capture, or a first replay that differs from the
eager walk of its stage, raises from :meth:`start`: nothing falls back.

Results are bit-identical to sequential ``run()`` per request: stages
run the same engine programs on the same activations (the ring only
moves int8 boundary buffers), and padded rows and microbatches are
sliced away before delivery.
"""
from __future__ import annotations

import math
import queue
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.compiler.pipeline import trace_fused
from repro_torch.core.admission import AdmissionController, AdmissionError
from repro_torch.core.dataflow import StageRing
from repro_torch.kernels import _build
from repro_torch.models.cnn import cnn_input_shape
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, monotonic_clock
from repro_torch.runtime.cnn_serving import (_STOP, METRIC_WINDOW,
                                             REQUEST_ROW_WINDOW, CnnRequest,
                                             MicrobatchPacker,
                                             ServingObsMixin, ServingReport)
from repro_torch.runtime.pipeline import resolve_device

__all__ = ["ShardedCnnServingEngine", "ShardedServingReport"]

# host buffers the dispatcher packs rounds into: one is refilled only
# after its copy to the card has finished (its event)
STAGING_BUFFERS = 2


@dataclass
class ShardedServingReport(ServingReport):
    """The :class:`ServingReport` fields plus the staged-topology view:
    how the rounds filled, what each stage streamed, and the mesh
    shape the numbers were produced on."""

    n_stages: int = 1
    rounds: int = 0
    round_microbatches: int = 0
    empty_microbatches: int = 0       # whole-padding slots in short rounds
    stage_hbm_words_per_image: Tuple[int, ...] = ()
    shard_requests: Tuple[int, ...] = ()

    @property
    def round_fill_fraction(self) -> float:
        total = self.rounds * self.round_microbatches
        return self.microbatches / total if total else 0.0


class _StageGraph:
    """One stage's captured CUDA graph as a ring stage program: the ring
    copies each boundary straight into ``static_in``; a call replays the
    graph on the current stream and returns ``static_out`` itself (the
    ring's consumed events keep it until the next stage has copied it),
    counting the launches its capture recorded."""

    def __init__(self, runner):
        self.runner = runner
        self.static_in = runner.static_in

    def __call__(self, params, x):
        if x is not self.static_in:
            self.static_in.copy_(x)
        self.runner.graph.replay()
        _build.count_replay(self.runner.launches)
        return self.runner.static_out


class _StageWalk:
    """One stage's eager walk on the CPU, bound to its device's params."""

    def __init__(self, fn, params):
        self.fn = fn
        self.params = params

    def __call__(self, _params, x):
        return self.fn(self.params, x)


class ShardedCnnServingEngine(ServingObsMixin):
    """Credit-bounded serving over a compiled pipeline partitioned
    across the slots of a mesh axis (see module docstring).

    ``microbatch`` is the per-stage activation batch (one ring slot);
    ``round_microbatches`` (default ``8 * n_stages``) is how many
    microbatches one staged dispatch carries — larger rounds amortize
    the S - 1 fill bubble (``pipeline_stats``).  ``credits`` bounds
    dispatched-not-delivered microbatches across the mesh (default
    ``2 * round_microbatches``: one round in flight, one filling).

    Use as a context manager (``with cp.serve_sharded(params, mesh=m)
    as eng``) or call :meth:`start`/:meth:`stop`; :meth:`submit` is
    thread-safe, with an optional explicit target shard.
    """

    def __init__(self, compiled, params, *, mesh, axis: str = "model",
                 microbatch: int = 4,
                 round_microbatches: Optional[int] = None,
                 credits: Optional[int] = None, queue_depth: int = 64,
                 act_scale: float = 0.05,
                 tracer=None, metrics: Optional[MetricsRegistry] = None,
                 clock: Optional[Callable[[], float]] = None,
                 metric_window: int = METRIC_WINDOW,
                 request_row_window: int = REQUEST_ROW_WINDOW):
        if microbatch <= 0:
            raise ValueError("microbatch must be positive")
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        if axis not in sizes:
            raise ValueError(
                f"mesh has no axis {axis!r}; available axes: {sizes}")
        self.compiled = compiled
        self.params = params
        self.mesh = mesh
        self.axis = axis
        self.n_stages = sizes[axis]
        devices = mesh.axis_devices(axis)
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"the {axis!r} axis mixes device types: "
                             f"{[str(d) for d in devices]}")
        self.devices = tuple(resolve_device(d) for d in devices)
        self.microbatch = microbatch
        self.act_scale = act_scale
        self.partition = compiled.partition(self.n_stages)
        M = (8 * self.n_stages if round_microbatches is None
             else round_microbatches)
        if M < 1:
            raise ValueError("round_microbatches must be >= 1")
        self.round_microbatches = M
        credits = 2 * M if credits is None else credits
        if credits < M:
            raise ValueError(
                f"credits ({credits}) must cover one full round of "
                f"{M} microbatches — a smaller bound would deadlock the "
                f"round dispatcher")
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.metrics = MetricsRegistry() if metrics is None else metrics
        if clock is None:
            clock = self.tracer.clock if self.tracer.enabled \
                else monotonic_clock
        self._clock = clock
        self.admission = AdmissionController(credits,
                                             name="sharded-serving",
                                             clock=clock)
        self._in_shape = cnn_input_shape(compiled.plan.cfg, microbatch)
        self._round_shape = (M,) + self._in_shape
        self.words_per_image = sum(
            compiled.plan.hbm_words_per_image().values())

        # shard-local producers: one bounded queue + packer per stage
        self._queues = [queue.Queue(maxsize=queue_depth)
                        for _ in range(self.n_stages)]
        self._packers = [MicrobatchPacker(q, microbatch)
                         for q in self._queues]
        self._shard_requests = [0] * self.n_stages
        self._rr_submit = 0           # round-robin producer assignment
        self._rr_drain = 0            # round-robin dispatcher fairness
        self._work = threading.Condition()   # "a shard queue has work"

        #: per stage, what start() captured: the stage program the ring
        #: runs and the Eq. 2 stats of its capture
        self.stage_programs: List[Callable] = []
        self.stage_stats: List[tuple] = []
        self._device_params: Dict[torch.device, Any] = {}
        self._ring: Optional[StageRing] = None
        self._upload = self._copy_stream = None
        self._staging: List[Tuple[torch.Tensor, Any]] = []
        self._slot = 0
        self._inflight: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._started = False
        self._stopped = False
        self._error: Optional[BaseException] = None

        self._lock = threading.Condition()
        self._submit_lock = threading.Lock()
        self._accepting = False
        self._rid = 0
        self._outstanding = 0
        self._latencies: deque = deque(maxlen=metric_window)
        self._request_rows: deque = deque(maxlen=request_row_window)
        self._images_done = 0
        self._requests_done = 0
        self._mb_count = 0
        self._round_count = 0
        self._padded_rows = 0
        self._empty_microbatches = 0
        self._depth_samples: deque = deque(maxlen=metric_window)
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        # stall attribution (see ServingObsMixin): round-dispatcher idle
        # time between rounds; admission waits live on the controller
        self._gap_s = 0.0
        self._modelled = False        # False = not yet computed (lazy)

    # -- lifecycle -----------------------------------------------------------

    def _params_on(self, device: torch.device):
        """The params the stages on ``device`` read, moved there once
        (tensors already there are not copied)."""
        got = self._device_params.get(device)
        if got is None:
            names = {n for sp, d in zip(self.partition.stages, self.devices)
                     if d == device for n in sp.layers}
            got = {n: {k: t.to(device) for k, t in leaves.items()}
                   for n, leaves in self.params.items() if n in names}
            self._device_params[device] = got
        return got

    def start(self) -> "ShardedCnnServingEngine":
        if self._started:
            return self
        if self._stopped:
            raise RuntimeError(
                "sharded serving engine is single-use; create a new one "
                "(CompiledPipeline.serve_sharded) instead of restarting")
        part = self.partition
        S = self.n_stages
        mb = self.microbatch
        # one capture a stage, on a seeded int8 input of its boundary
        # shape: trace_fused checks the first replay against the eager
        # walk bit for bit and raises on any failure
        gen = torch.Generator().manual_seed(0)
        programs, stats = [], []
        for s, sp in enumerate(part.stages):
            dev = self.devices[s]
            params = self._params_on(dev)
            x = torch.randint(-127, 128, part.boundary_shape(s, mb),
                              generator=gen, dtype=torch.int8).to(dev)
            trace, _ = trace_fused(self.compiled, params, x,
                                   act_scale=self.act_scale,
                                   layer_range=sp.layer_range)
            stats.append(trace.stats)
            programs.append(_StageGraph(trace.fn) if dev.type == "cuda"
                            else _StageWalk(trace.fn, params))

        # the split-graph Eq. 2 guarantee, both directions: the sliced
        # plan verifies against the sliced stats template per stage...
        part.verify_eq2(batch=mb)
        # ...and the executed per-stage counters of the stage captures
        # agree with each stage program's plan-side words
        n_nodes = sum(len(c) for c in stats)
        L = len(self.compiled.plan.schedules)
        if n_nodes != L:
            raise RuntimeError(
                f"staged trace dispatched {n_nodes} node(s), plan has {L}")
        for s, sp in enumerate(part.stages):
            traced = sum(st.hbm_words for st in stats[s])
            want = sp.hbm_words_per_image * mb
            if traced != want:
                raise RuntimeError(
                    f"stage {s} traced Eq. 2 words ({traced}) disagree "
                    f"with its stage plan ({sp.hbm_words_per_image} "
                    f"words/image x {mb})")
        self.stage_programs = programs
        self.stage_stats = stats
        self._ring = StageRing(
            programs, self.devices,
            boundary_shapes=[None] + [part.boundary_shape(s, mb)
                                      for s in range(1, S)],
            out_shape=part.out_shape(mb), out_dtype=torch.float32,
            carry_dtype=torch.int8)
        if self.devices[0].type == "cuda":
            self._upload = torch.cuda.Stream(self.devices[0])
            self._copy_stream = torch.cuda.Stream(self.devices[-1])
            self._staging = [
                (torch.zeros(self._round_shape, dtype=torch.int8,
                             pin_memory=True), torch.cuda.Event())
                for _ in range(STAGING_BUFFERS)]

        self._threads = [
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name="sharded-serving-dispatch"),
            threading.Thread(target=self._complete_loop, daemon=True,
                             name="sharded-serving-complete"),
        ]
        for t in self._threads:
            t.start()
        self._started = True
        self._accepting = True
        return self

    def stop(self) -> None:
        """Drain everything already submitted, then shut down and verify
        the admission accounting is quiescent.  Single-use."""
        if not self._started:
            return
        with self._submit_lock:
            self._accepting = False
            for q in self._queues:
                q.put(_STOP)
        with self._work:
            self._work.notify_all()
        for t in self._threads:
            t.join()
        self._started = False
        self._stopped = True
        if self._error is None:
            self.admission.assert_quiescent()

    def __enter__(self) -> "ShardedCnnServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission ----------------------------------------------------------

    def submit(self, images, shard: Optional[int] = None) -> CnnRequest:
        """Enqueue ``images`` ([n,H,W,C] int8) on a shard-local producer
        queue — ``shard`` picks the queue explicitly (a producer local
        to that stage's slot), default round-robins.  Blocks when the
        target shard's bounded queue is full."""
        if not self._started:
            raise RuntimeError("sharded serving engine not started")
        if self._error is not None:
            raise RuntimeError("sharded serving engine failed") \
                from self._error
        arr = np.asarray(images)
        if arr.ndim == 3:
            arr = arr[None]
        want = self._in_shape[1:]
        if arr.ndim != 4 or arr.shape[1:] != want or arr.shape[0] < 1:
            raise ValueError(
                f"expected images [n,{want[0]},{want[1]},{want[2]}], "
                f"got {arr.shape}")
        if shard is not None and not 0 <= shard < self.n_stages:
            raise ValueError(
                f"shard {shard} outside [0, {self.n_stages})")
        arr = arr.astype(np.int8, copy=False)
        with self._lock:
            self._rid += 1
            req = CnnRequest(self._rid, arr, now=self._clock())
            req.hbm_words = req.n * self.words_per_image
            self._outstanding += 1
            if shard is None:
                shard = self._rr_submit % self.n_stages
                self._rr_submit += 1
        if self.tracer.enabled:
            self.tracer.begin("request", "request", req.rid,
                              images=req.n, shard=shard)
        with self._submit_lock:
            while True:
                if not self._accepting:
                    self._reject(req)
                    raise RuntimeError(
                        "sharded serving engine is stopping")
                try:
                    self._queues[shard].put(req, timeout=0.5)
                    break
                except queue.Full:
                    continue
        # only requests that actually entered a shard queue advance the
        # serving clock and the submitted counters (a submit() that lost
        # the race against stop() must skew neither wall_s nor the
        # per-shard accounting)
        with self._lock:
            self._shard_requests[shard] += 1
            if self._t0 is None or req.t_submit < self._t0:
                self._t0 = req.t_submit
        self.metrics.counter("serving_requests_submitted",
                             shard=shard).inc()
        with self._work:
            self._work.notify_all()
        if self._error is not None:
            self._sweep_queues(self._error)
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
            raise RuntimeError("sharded serving engine failed") \
                from self._error

    def serve(self, batches: Sequence[Any]
              ) -> Tuple[List[np.ndarray], ShardedServingReport]:
        """Closed-loop convenience: submit all ``batches`` (round-robin
        over shards), drain, return ([logits per batch], report)."""
        reqs = [self.submit(b) for b in batches]
        self.drain()
        return [r.result() for r in reqs], self.report()

    # -- reporting -----------------------------------------------------------

    def report(self) -> ShardedServingReport:
        metrics = self._metrics_snapshot()
        with self._lock:
            lat = sorted(self._latencies)
            wall = (self._t_last - self._t0) \
                if (self._t0 is not None and self._t_last is not None) \
                else 0.0
            images = self._images_done
            rows = (self._mb_count + self._empty_microbatches) \
                * self.microbatch

            def pct(p: float) -> float:
                if not lat:
                    return 0.0
                return 1e3 * lat[max(0, math.ceil(p * len(lat)) - 1)]

            return ShardedServingReport(
                requests=self._requests_done,
                images=images,
                microbatches=self._mb_count,
                microbatch_size=self.microbatch,
                padded_rows=self._padded_rows,
                credits=self.admission.capacity,
                max_in_flight=self.admission.max_in_flight_seen,
                wall_s=wall,
                images_per_s=images / wall if wall > 0 else 0.0,
                p50_ms=pct(0.50), p95_ms=pct(0.95), p99_ms=pct(0.99),
                hbm_words_per_image=self.words_per_image,
                hbm_words_useful=images * self.words_per_image,
                hbm_words_executed=rows * self.words_per_image,
                queue_depth=list(self._depth_samples),
                request_rows=list(self._request_rows),
                dispatched_rows=rows,
                microbatch_shapes={str(self.microbatch): self._mb_count}
                if self._mb_count else {},
                trace_cache=self.compiled.trace_cache_stats(),
                metrics=metrics,
                bandwidth_efficiency=self._stall_report(wall),
                n_stages=self.n_stages,
                rounds=self._round_count,
                round_microbatches=self.round_microbatches,
                empty_microbatches=self._empty_microbatches,
                stage_hbm_words_per_image=tuple(
                    s.hbm_words_per_image for s in self.partition.stages),
                shard_requests=tuple(self._shard_requests),
            )

    # -- worker threads ------------------------------------------------------

    def _dispatch_loop(self) -> None:
        try:
            while True:
                # dispatch-gap attribution: time between rounds with
                # nothing to pack (counted once serving has begun)
                t_idle = self._clock()
                packs = self._collect_round()
                if self._round_count > 0:
                    self._gap_s += self._clock() - t_idle
                if packs is None:
                    break
                self._dispatch_round(packs)
        except BaseException as exc:
            self._fail(exc)
        finally:
            self._inflight.put(None)                 # completer sentinel

    def _next_pack(self, *, block: bool):
        """One packed microbatch from the first shard (round-robin from
        the fairness cursor) with work available; ``block=True`` waits
        for any shard to produce, returning None only when every shard's
        stop sentinel has been drained."""
        while True:
            for k in range(self.n_stages):
                p = self._packers[(self._rr_drain + k) % self.n_stages]
                got = p.collect(block=False)
                if got is not None:
                    self._rr_drain = (self._rr_drain + k + 1) \
                        % self.n_stages
                    return got
            if all(p.saw_stop for p in self._packers):
                return None
            if not block:
                return None
            with self._work:
                self._work.wait(0.02)

    def _collect_round(self):
        """Fill a round: block for the first microbatch, then greedily
        take whatever the shards have, never waiting once at least one
        microbatch is held (the packer's latency-over-occupancy policy,
        lifted to rounds).  Short rounds are padded with empty slots."""
        if self.tracer.enabled:
            with self.tracer.span("pack", "pack"):
                return self._collect_round_inner()
        return self._collect_round_inner()

    def _collect_round_inner(self):
        packs: List[Tuple[list, int]] = []
        while len(packs) < self.round_microbatches:
            got = self._next_pack(block=not packs)
            if got is None:
                break
            packs.append(got)
        return packs or None

    def _stage_round(self, packs) -> torch.Tensor:
        """The round's images in a host buffer, padded rows and empty
        slots zero: on the card a pinned buffer whose last copy has
        finished."""
        if self._upload is None:
            staged = torch.empty(self._round_shape, dtype=torch.int8)
        else:
            staged, copied = self._staging[self._slot]
            copied.synchronize()             # its last copy has finished
        buf = staged.numpy()
        for m, (rows, filled) in enumerate(packs):
            for req, roff, moff, take in rows:
                buf[m, moff:moff + take] = req.images[roff:roff + take]
            buf[m, filled:] = 0
        buf[len(packs):] = 0
        return staged

    def _run_round(self, staged: torch.Tensor):
        """The round to the device and through the ring: on the card the
        copy of the pinned buffer on the upload stream (its event
        recorded), the ring forked from there, and an event on the last
        stage's stream the completer waits on; on the CPU the ring runs
        here.  Returns (logits [M, mb, classes], event or None)."""
        if self._upload is None:
            return self._ring.run(None, staged), None
        _, copied = self._staging[self._slot]
        self._slot = (self._slot + 1) % len(self._staging)
        with torch.cuda.stream(self._upload):
            x = staged.to(self.devices[0], non_blocking=True)
            copied.record(self._upload)
            logits = self._ring.run(None, x, join=False)
        done = torch.cuda.Event()
        done.record(self._ring.streams[-1])
        return logits, done

    def _dispatch_round(self, packs) -> None:
        try:
            self._dispatch_round_inner(packs)
        except BaseException as exc:
            # the round's requests left their queues: fail them here
            # (the in-flight queue and the packers' cursors are swept by
            # _fail) so that none waits forever
            for rows, _filled in packs:
                for req, *_ in rows:
                    req._fail(exc)
            raise

    def _dispatch_round_inner(self, packs) -> None:
        tracer = self.tracer
        k = len(packs)
        staged = self._stage_round(packs)
        # the §V-A cross-stage credit: one per microbatch between
        # dispatch and delivery, across the whole mesh
        # (admission.wait_seconds_total accrues the blocked time)
        if tracer.enabled:
            with tracer.span("credit_wait", "admission", microbatches=k):
                for _ in range(k):
                    if not self.admission.acquire():
                        raise AdmissionError(
                            "admission controller closed mid-serve")
        else:
            for _ in range(k):
                if not self.admission.acquire():
                    raise AdmissionError(
                        "admission controller closed mid-serve")
        if tracer.enabled:
            with tracer.span("dispatch", "dispatch", microbatches=k):
                logits, done = self._run_round(staged)
        else:
            logits, done = self._run_round(staged)
        t = self._clock()
        with self._lock:
            self._round_count += 1
            seq = self._round_count
            self._mb_count += k
            self._padded_rows += sum(
                self.microbatch - filled for _rows, filled in packs)
            self._empty_microbatches += self.round_microbatches - k
            depth = sum(p.depth_hint for p in self._packers)
            self._depth_samples.append(
                (t - self._t0 if self._t0 is not None else 0.0, depth))
        if tracer.enabled:
            # the in-flight round view: one async round span plus a
            # per-stage round annotation carrying the per-stage plan
            # words (the stage programs run on the card's streams, so
            # per-stage host timing does not exist)
            tracer.begin("round", "in_flight", seq, microbatches=k)
            tracer.instant(
                "stage_round", "round", round=seq, microbatches=k,
                stage_hbm_words_per_image=[
                    s.hbm_words_per_image for s in self.partition.stages])
            tracer.counter("queue_depth", depth)
        self.metrics.counter("serving_rounds").inc()
        self.metrics.counter("serving_microbatches").inc(k)
        self.metrics.counter("serving_empty_microbatches").inc(
            self.round_microbatches - k)
        self.metrics.gauge("serving_queue_depth").set(depth)
        self._inflight.put((logits, packs, k, seq, done))

    def _complete_loop(self) -> None:
        try:
            while True:
                item = self._inflight.get()
                if item is None:
                    break
                logits, packs, k, seq, done = item
                if done is None:
                    arr = logits.numpy()
                else:
                    done.synchronize()
                    with torch.cuda.stream(self._copy_stream):
                        arr = logits.cpu().numpy()
                self.admission.release(k)
                now = self._clock()
                if self.tracer.enabled:
                    self.tracer.end("round", "in_flight", seq)
                finished: List[CnnRequest] = []
                if self.tracer.enabled:
                    with self.tracer.span("deliver", "delivery", seq=seq):
                        self._deliver(packs, arr, now, finished)
                else:
                    self._deliver(packs, arr, now, finished)
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
        except BaseException as exc:
            self._fail(exc)

    @staticmethod
    def _deliver(packs, arr: np.ndarray, now: float,
                 finished: List[CnnRequest]) -> None:
        for m, (rows, _filled) in enumerate(packs):
            for req, roff, moff, take in rows:
                if req._deliver(roff, arr[m, moff:moff + take], now):
                    finished.append(req)

    # -- failure plumbing (mirrors CnnServingEngine) -------------------------

    def _reject(self, req: CnnRequest) -> None:
        """Back out a request that never entered a shard queue (wall_s,
        shard counts and the submitted counter were not yet advanced —
        they move post-enqueue); close its trace span."""
        with self._lock:
            self._outstanding -= 1
            self._lock.notify_all()
        if self.tracer.enabled:
            self.tracer.end("request", "request", req.rid, rejected=True)

    def _fail(self, exc: BaseException) -> None:
        self._accepting = False
        with self._lock:
            if self._error is None:
                self._error = exc
            self._lock.notify_all()
        self.admission.close()
        with self._work:
            self._work.notify_all()
        self._sweep_queues(exc)
        for p in self._packers:
            p.fail_cursor(exc)

    def _sweep_queues(self, exc: BaseException) -> None:
        for q in list(self._queues) + [self._inflight]:
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if isinstance(item, CnnRequest):
                    item._fail(exc)
                elif isinstance(item, tuple):
                    for rows, _filled in item[1]:
                        for req, *_ in rows:
                            req._fail(exc)
                else:
                    q.put(item)
                    break
