"""Credit-based admission control — the §V-A flow-control law as a value:
``AdmissionError`` and ``AdmissionController``, copied from the JAX
package's framework-free ``core/admission.py`` (what the LM serving engine
uses).  A request enters only when a credit (a decode slot) is free, so
the KV cache can never be overrun.  ``replay_schedule``, the weighted-fair
scheduler and the staged replay come with CNN serving.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional


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
        self.clock = time.perf_counter if clock is None else clock
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
