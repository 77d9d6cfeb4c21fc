"""Credit-based admission control — the §V-A flow-control law as a value.

H2PIPE never runs one image at a time: the accelerator admits a new
image every initiation interval, with the number in flight bounded by
FIFO credits so no stage can be overrun and no head-of-line blocking is
possible (§V-A).  Three runtimes need that law at serving time — the LM
batch engine in ``runtime/serving.py``, the CNN streaming engine in
``runtime/cnn_serving.py`` and the multi-tenant front end in
``runtime/frontend.py`` — so the slot/credit bookkeeping they share
lives here, once.  The module is a copy of the JAX package's
framework-free ``core/admission.py``:

:class:`AdmissionController`
    The thread-safe runtime object: ``capacity`` credits, blocking /
    non-blocking ``acquire``, ``release`` on completion, and invariant
    hooks (``max_in_flight_seen``, admitted/completed totals,
    :meth:`check_invariants`) that stress tests assert against — the
    observable proof that producers never exceed the credit bound.

:func:`replay_schedule`
    The same controller driven on a discrete clock: at most one
    admission per tick when a credit is free, completion (and credit
    return) ``latency_ticks`` after admission, completions processed
    after the tick's admission — exactly the cycle ordering of
    ``fifo_sim``'s credit-mode prefetcher (issue before consume within
    a cycle).  The autotuner's credit solver
    (``compiler/autotune.py::solve_serving_credits``) sweeps it.

:class:`WeightedFairScheduler`, :func:`jain_fairness`
    Deficit round-robin with deadline promotion over tenants, and the
    fairness index the front end reports.

:func:`replay_staged_schedule`
    The law over an S-stage ring (one microbatch per stage per tick),
    the schedule a sharded pipeline of S stages runs.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional

from repro_torch.obs.trace import monotonic_clock


class AdmissionError(RuntimeError):
    """A credit-accounting invariant was violated (over-release, or a
    closed controller still holding in-flight work)."""


class AdmissionController:
    """Bounded in-flight admission: ``capacity`` credits, one per unit of
    in-flight work (a decode slot, a dispatched microbatch).

    Thread-safe and observable: concurrent producers block in
    :meth:`acquire` until a credit frees; completions :meth:`release`.
    ``max_in_flight_seen`` records the high-water mark so tests can
    assert the credit bound held over an entire concurrent run, not just
    at sample points.

    Credit *wait time* is first-class observability: every blocking
    :meth:`acquire` measures how long the caller sat without a credit on
    the injectable ``clock`` (default ``time.perf_counter``), summed in
    ``wait_seconds_total`` with ``blocked_acquires`` counting acquires
    that had to wait at all — the measured half of the §V-A credit
    stalls that ``fifo_sim`` models, surfaced by the serving reports'
    ``bandwidth_efficiency`` section.
    """

    def __init__(self, capacity: int, *, name: str = "admission",
                 clock: Optional[Callable[[], float]] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.name = name
        self.capacity = capacity
        self.clock = monotonic_clock if clock is None else clock
        self._cv = threading.Condition()
        self._free = capacity
        self._closed = False
        self.max_in_flight_seen = 0
        self.admitted_total = 0
        self.completed_total = 0
        self.wait_seconds_total = 0.0
        self.blocked_acquires = 0

    # -- credit operations ---------------------------------------------------

    @property
    def free_credits(self) -> int:
        with self._cv:
            return self._free

    @property
    def in_flight(self) -> int:
        with self._cv:
            return self.capacity - self._free

    def try_acquire(self) -> bool:
        """Take a credit if one is free; never blocks."""
        with self._cv:
            if self._closed or self._free == 0:
                return False
            self._take_locked()
            return True

    def acquire(self, timeout: Optional[float] = None) -> bool:
        """Block until a credit frees (or ``timeout`` elapses / the
        controller closes).  Returns whether a credit was taken.  Time
        spent blocked accrues to ``wait_seconds_total``."""
        with self._cv:
            if self._free == 0 and not self._closed:
                # counted BEFORE parking, so a watcher can observe a
                # blocked dispatcher while it is still blocked
                self.blocked_acquires += 1
                t0 = self.clock()
                ok = self._cv.wait_for(
                    lambda: self._free > 0 or self._closed, timeout)
                self.wait_seconds_total += self.clock() - t0
                if not ok:
                    return False
            if self._closed:
                return False
            self._take_locked()
            return True

    def release(self, n: int = 1) -> None:
        """Return ``n`` credits (one completed unit each)."""
        with self._cv:
            if n < 0 or self._free + n > self.capacity:
                raise AdmissionError(
                    f"{self.name}: release({n}) with {self._free}/"
                    f"{self.capacity} credits free — more completions "
                    f"than admissions")
            self._free += n
            self.completed_total += n
            self._cv.notify_all()

    @contextmanager
    def slot(self, timeout: Optional[float] = None):
        """``with controller.slot(): ...`` — acquire/release bracket."""
        if not self.acquire(timeout):
            raise AdmissionError(f"{self.name}: no credit within {timeout}s")
        try:
            yield
        finally:
            self.release()

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def close(self) -> None:
        """Wake all blocked acquirers; subsequent acquires fail."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def _take_locked(self) -> None:
        self._free -= 1
        self.admitted_total += 1
        inflight = self.capacity - self._free
        if inflight > self.max_in_flight_seen:
            self.max_in_flight_seen = inflight

    # -- invariant hooks -----------------------------------------------------

    def check_invariants(self) -> None:
        """Raise :class:`AdmissionError` unless every credit law held:
        0 <= free <= capacity, high-water mark within capacity, and
        conservation (admitted - completed == in flight)."""
        with self._cv:
            free = self._free
            if not 0 <= free <= self.capacity:
                raise AdmissionError(
                    f"{self.name}: {free} free credits outside "
                    f"[0, {self.capacity}]")
            if self.max_in_flight_seen > self.capacity:
                raise AdmissionError(
                    f"{self.name}: {self.max_in_flight_seen} in flight "
                    f"exceeded capacity {self.capacity}")
            if self.admitted_total - self.completed_total \
                    != self.capacity - free:
                raise AdmissionError(
                    f"{self.name}: admitted {self.admitted_total} - "
                    f"completed {self.completed_total} != "
                    f"{self.capacity - free} in flight")

    def assert_quiescent(self) -> None:
        """All admitted work completed and every credit returned."""
        self.check_invariants()
        with self._cv:
            if self._free != self.capacity:
                raise AdmissionError(
                    f"{self.name}: {self.capacity - self._free} unit(s) "
                    f"still in flight at shutdown")


# ---------------------------------------------------------------------------
# the admission law on a discrete clock
# ---------------------------------------------------------------------------


@dataclass
class AdmissionTrace:
    """What the tick-law replay did: per-item admission/completion ticks
    plus the aggregates the cycle model predicts."""

    capacity: int
    latency_ticks: int
    admit_ticks: List[int] = field(default_factory=list)
    complete_ticks: List[int] = field(default_factory=list)
    makespan: int = 0                 # tick the last item completed
    max_in_flight: int = 0
    idle_ticks: int = 0               # ticks with no completion (= stalls)


def replay_schedule(n_items: int, *, capacity: int,
                    latency_ticks: int,
                    controller: Optional[AdmissionController] = None
                    ) -> AdmissionTrace:
    """Drive an :class:`AdmissionController` through the static admission
    schedule: one admission per tick when a credit is free; the item
    admitted at tick ``a`` completes (returning its credit) at tick
    ``a + latency_ticks``, processed *after* that tick's admission —
    fifo_sim's credit-mode cycle ordering (prefetcher issue precedes
    engine consume within a cycle), and an S-stage pipeline's schedule
    when ``latency_ticks = n_stages - 1`` (microbatch ``m`` admitted at
    tick ``m`` leaves the pipe at tick ``m + S - 1``: makespan
    ``M + S - 1``).

    Passing a ``controller`` verifies that *instance*'s bookkeeping tick
    for tick; by default a fresh one of ``capacity`` credits is used.
    The law is real code, not a closed form — the property tests equate
    it with ``fifo_sim.simulate(..., "credit")`` on the single-engine
    topology (makespan, stalls and the in-flight bound all match).
    """
    if latency_ticks < 0:
        raise ValueError("latency_ticks must be >= 0")
    ctl = controller if controller is not None \
        else AdmissionController(capacity, name="replay")
    if ctl.capacity != capacity:
        raise ValueError(f"controller capacity {ctl.capacity} != {capacity}")
    if ctl.closed or ctl.free_credits < capacity:
        raise ValueError(
            f"controller must be open and idle to replay the schedule "
            f"(closed={ctl.closed}, {ctl.free_credits}/{capacity} free)")
    trace = AdmissionTrace(capacity=capacity, latency_ticks=latency_ticks)
    inflight: dict = {}               # completion tick -> count
    pending = n_items
    tick = 0
    while len(trace.complete_ticks) < n_items:
        tick += 1
        if pending and ctl.try_acquire():
            pending -= 1
            trace.admit_ticks.append(tick)
            done_at = tick + latency_ticks
            inflight[done_at] = inflight.get(done_at, 0) + 1
        trace.max_in_flight = max(trace.max_in_flight, ctl.in_flight)
        done = inflight.pop(tick, 0)
        if done:
            ctl.release(done)
            trace.complete_ticks.extend([tick] * done)
        else:
            trace.idle_ticks += 1
        ctl.check_invariants()
    trace.makespan = tick
    if controller is None:
        ctl.assert_quiescent()
    return trace


# ---------------------------------------------------------------------------
# weighted-fair, deadline-aware tenant scheduling (the front-end tier)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HeadOfQueue:
    """What the scheduler needs to know about one backlogged tenant:
    the service cost of its head request (images — the currency the
    weights are fair over) and, optionally, that request's ABSOLUTE
    deadline on the caller's clock."""

    cost: float
    deadline: Optional[float] = None


class WeightedFairScheduler:
    """Deficit round-robin over registered tenants, with deadline-aware
    promotion — the multi-tenant scheduling tier LAYERED OVER the
    unchanged :class:`AdmissionController` (the §V-A credit invariants
    and their property tests stay exactly as they are; this class only
    decides *whose* request is offered to the credit bound next).

    The law, per :meth:`pick` call over the currently backlogged tenants:

      * a tenant whose head request's slack (``deadline - now``) has gone
        NEGATIVE is promoted immediately, most-overdue first, regardless
        of weights — its cost is still charged against its deficit (which
        may go negative), so a tenant cannot use deadlines to escape its
        long-run weighted share;
      * otherwise classic DRR: visiting a backlogged tenant grants it
        ``quantum * weight`` of deficit once per visit; it is served
        while its deficit covers the head cost, then the cursor moves
        on.  Long-run delivered cost is proportional to weight for
        continuously backlogged tenants (property-tested);
      * a tenant observed with an EMPTY queue has its deficit reset —
        an idle tenant must not hoard credit and then burst past its
        share (standard DRR).

    Thread-compatibility: calls are expected from ONE scheduling thread
    (the front-end dispatcher); the class keeps no locks of its own.
    """

    def __init__(self, *, quantum: float = 1.0):
        if quantum <= 0:
            raise ValueError(f"quantum must be positive, got {quantum}")
        self.quantum = quantum
        self._weights: Dict[Any, float] = {}
        self._deficit: Dict[Any, float] = {}
        self._ring: List[Any] = []        # registration order
        self._cursor = 0
        self._granted = False             # quantum granted at this stop?
        self.picks: Dict[Any, int] = {}
        self.served_cost: Dict[Any, float] = {}
        self.promotions = 0

    # -- registration --------------------------------------------------------

    def register(self, key: Any, weight: float = 1.0) -> None:
        if weight <= 0:
            raise ValueError(
                f"tenant {key!r}: weight must be positive, got {weight}")
        if key in self._weights:
            raise ValueError(f"tenant {key!r} already registered")
        self._weights[key] = float(weight)
        self._deficit[key] = 0.0
        self._ring.append(key)
        self.picks[key] = 0
        self.served_cost[key] = 0.0

    def unregister(self, key: Any) -> None:
        if key not in self._weights:
            raise ValueError(f"tenant {key!r} not registered")
        at = self._ring.index(key)
        del self._ring[at]
        del self._weights[key]
        del self._deficit[key]
        if not self._ring:
            self._cursor = 0
            self._granted = False
            return
        if at < self._cursor:
            self._cursor -= 1
        elif at == self._cursor:
            self._granted = False
        self._cursor %= len(self._ring)

    @property
    def tenants(self) -> List[Any]:
        return list(self._ring)

    def weight(self, key: Any) -> float:
        return self._weights[key]

    # -- scheduling ----------------------------------------------------------

    def pick(self, backlog: Mapping[Any, HeadOfQueue], *,
             now: float = 0.0) -> Any:
        """Choose which backlogged tenant's head request is served next
        and charge its cost.  ``backlog`` maps registered tenant keys to
        their :class:`HeadOfQueue`; tenants absent from it are treated
        as idle (deficit reset).  Raises :class:`ValueError` on an empty
        or unknown backlog."""
        if not backlog:
            raise ValueError("pick() needs at least one backlogged tenant")
        for key in backlog:
            if key not in self._weights:
                raise ValueError(f"tenant {key!r} not registered")
        # deadline promotion: any head whose slack went negative is
        # served now, most overdue first (ties: registration order)
        overdue = sorted(
            (h.deadline - now, self._ring.index(k), k)
            for k, h in backlog.items()
            if h.deadline is not None and h.deadline - now <= 0.0)
        if overdue:
            _, _, key = overdue[0]
            self.promotions += 1
            self._serve(key, backlog[key].cost)
            return key
        # classic DRR from the cursor
        idle = [k for k in self._ring if k not in backlog]
        for k in idle:
            self._deficit[k] = 0.0
        # each full ring pass grants every backlogged tenant one quantum,
        # so the loop terminates in <= max(cost / (quantum * weight))
        # passes; the cap only trips on a pathological cost/quantum ratio
        for _ in range(1000 * max(1, len(self._ring))):
            key = self._ring[self._cursor]
            head = backlog.get(key)
            if head is None:
                self._advance()
                continue
            if not self._granted:
                self._deficit[key] += self.quantum * self._weights[key]
                self._granted = True
            if self._deficit[key] >= head.cost - 1e-9:
                self._serve(key, head.cost)
                return key
            self._advance()
        raise RuntimeError(
            "WeightedFairScheduler.pick did not converge — head cost "
            "vastly exceeds quantum * weight; raise the quantum")

    def _advance(self) -> None:
        self._cursor = (self._cursor + 1) % len(self._ring)
        self._granted = False

    def _serve(self, key: Any, cost: float) -> None:
        self._deficit[key] -= cost
        self.picks[key] += 1
        self.served_cost[key] += cost


def jain_fairness(shares: Mapping[Any, float]) -> float:
    """Jain's fairness index over per-tenant normalized shares
    (``sum(x)^2 / (n * sum(x^2))``): 1.0 when every share is equal,
    ``1/n`` when one tenant holds everything.  Used by the front-end
    report over delivered images/s divided by tenant weight."""
    xs = [float(v) for v in shares.values()]
    if not xs:
        return 1.0
    sq = sum(x * x for x in xs)
    if sq == 0.0:
        return 1.0
    return (sum(xs) ** 2) / (len(xs) * sq)


# ---------------------------------------------------------------------------
# the admission law over a STAGED topology (the sharded mesh pipeline)
# ---------------------------------------------------------------------------


@dataclass
class StagedTrace:
    """What the staged replay did: :class:`AdmissionTrace` aggregates
    plus the per-stage occupancy proof for the S-stage ring."""

    n_stages: int
    capacity: int
    admit_ticks: List[int] = field(default_factory=list)
    complete_ticks: List[int] = field(default_factory=list)
    makespan: int = 0
    max_in_flight: int = 0
    idle_ticks: int = 0
    #: max simultaneous microbatches observed on any single stage — the
    #: staged law says a stage holds at most ONE per tick (checked,
    #: not assumed)
    max_stage_occupancy: int = 0


def replay_staged_schedule(n_items: int, *, n_stages: int,
                           capacity: Optional[int] = None,
                           controller: Optional[AdmissionController] = None
                           ) -> StagedTrace:
    """Drive the (unchanged) :class:`AdmissionController` through the
    STAGED static schedule of a sharded S-stage pipeline: one
    admission per tick when a credit is free, the admitted microbatch
    hopping one stage per tick (stage ``s`` at tick ``a + s``) and
    returning its credit after the last stage, at tick
    ``a + n_stages - 1`` — :func:`replay_schedule` at
    ``latency_ticks = n_stages - 1``.

    Beyond the flat replay this checks the law the split topology adds:
    every stage of the ring holds at most ONE microbatch per tick
    (computed from the admission ticks, raising
    :class:`AdmissionError` on violation), so a ``capacity >= n_stages``
    bound admits back-to-back with makespan ``M + S - 1`` and a
    tighter bound only ever STALLS admission — it can never overrun a stage.
    """
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    capacity = n_stages if capacity is None else capacity
    ctl = controller if controller is not None \
        else AdmissionController(capacity, name="staged-replay")
    if ctl.capacity != capacity:
        raise ValueError(f"controller capacity {ctl.capacity} != {capacity}")
    if ctl.closed or ctl.free_credits < capacity:
        raise ValueError(
            f"controller must be open and idle to replay the schedule "
            f"(closed={ctl.closed}, {ctl.free_credits}/{capacity} free)")
    trace = StagedTrace(n_stages=n_stages, capacity=capacity)
    live: List[int] = []              # admit ticks of in-flight items
    pending = n_items
    tick = 0
    while len(trace.complete_ticks) < n_items:
        tick += 1
        if pending and ctl.try_acquire():
            pending -= 1
            trace.admit_ticks.append(tick)
            live.append(tick)
        trace.max_in_flight = max(trace.max_in_flight, ctl.in_flight)
        # ring occupancy this tick: item admitted at a sits on stage
        # tick - a while 0 <= tick - a < S
        stages = [tick - a for a in live if 0 <= tick - a < n_stages]
        occupancy = max((stages.count(s) for s in set(stages)), default=0)
        trace.max_stage_occupancy = max(trace.max_stage_occupancy,
                                        occupancy)
        if occupancy > 1:
            raise AdmissionError(
                f"staged replay: a stage held {occupancy} microbatches "
                f"at tick {tick} — the static schedule was violated")
        done = [a for a in live if tick - a == n_stages - 1]
        if done:
            live = [a for a in live if tick - a != n_stages - 1]
            ctl.release(len(done))
            trace.complete_ticks.extend([tick] * len(done))
        else:
            trace.idle_ticks += 1
        ctl.check_invariants()
    trace.makespan = tick
    if controller is None:
        ctl.assert_quiescent()
    return trace
