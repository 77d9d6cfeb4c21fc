"""Span/event tracing with Chrome Trace Event export — the measured half.

H2PIPE's headline evaluation is bandwidth efficiency against theoretical
limits (§VI): the paper attributes every lost cycle to a stall source.
The modelled side of that attribution already exists (``fifo_sim``,
``predict_stalls``); this module is the *measured* side — a thread-safe,
bounded tracer the serving runtimes emit host-side timeline events into,
exportable as Chrome Trace Event JSON (open ``chrome://tracing`` or
https://ui.perfetto.dev and load the file).

Design constraints, in order:

  * **zero overhead when disabled** — the default sink is
    :data:`NULL_TRACER`, whose methods are constant no-ops (no event
    objects, no lock, no per-call allocation); call sites additionally
    guard arg construction behind ``tracer.enabled``;
  * **bounded** — a long-lived server must not grow without bound: the
    event buffer is a ring of ``capacity`` events, oldest evicted first,
    with the eviction count surfaced (``dropped``) so a truncated trace
    is never mistaken for a complete one;
  * **injectable clock** — every timestamp comes from ``clock()``
    (default ``time.perf_counter``), so the latency/percentile logic of
    the serving engines is testable with a :class:`ManualClock` instead
    of sleeps, and all timestamps within one engine share one timebase;
  * **async in-flight spans** — a dispatched microbatch begins on the
    dispatcher thread and ends on the completer thread; Chrome's async
    event pairs (``ph: b``/``e`` with an ``id``) model exactly that.

Tracks (Chrome ``tid`` rows, one per pipeline phase):
``admission`` (credit wait), ``pack`` (microbatch packing), ``dispatch``
(graph replay enqueue), ``in_flight`` (device occupancy, async), ``delivery``
(result unpacking), ``request`` (per-request lifetime, async), ``round``
(sharded per-stage rounds).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "ManualClock",
           "TRACKS", "monotonic_clock", "chrome_trace_events",
           "validate_chrome_trace"]

#: the default monotonic timebase (injectable everywhere it is used)
monotonic_clock: Callable[[], float] = time.perf_counter

#: canonical track names, in display order.  Unknown tracks are allowed
#: (they get tids after these), but the serving engines stick to this set.
TRACKS: Tuple[str, ...] = ("request", "admission", "pack", "dispatch",
                           "in_flight", "delivery", "round")

_DEFAULT_CAPACITY = 65536


class ManualClock:
    """A settable monotonic clock for tests: starts at ``start``,
    advances ``step`` on every call (so concurrent threads still see
    strictly monotonic time), plus explicit :meth:`advance`.  Thread-safe
    — the serving engines call the clock from three threads."""

    def __init__(self, start: float = 0.0, step: float = 0.0):
        self._t = float(start)
        self.step = float(step)
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            t = self._t
            self._t += self.step
            return t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock must be monotonic; advance({dt})")
        with self._lock:
            self._t += dt

    @property
    def now(self) -> float:
        with self._lock:
            return self._t


class _NullSpan:
    """Reusable no-op context manager (one shared instance, so a
    disabled tracer's ``span()`` allocates nothing per call)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled sink: every method is a constant no-op.  Call sites
    check ``tracer.enabled`` before building event arguments, so a
    disabled engine pays one attribute read per would-be event."""

    enabled = False
    dropped = 0
    clock: Callable[[], float] = staticmethod(monotonic_clock)

    def instant(self, name: str, track: str = "dispatch",
                **args: Any) -> None:
        pass

    def begin(self, name: str, track: str, event_id: int,
              **args: Any) -> None:
        pass

    def end(self, name: str, track: str, event_id: int,
            **args: Any) -> None:
        pass

    def counter(self, name: str, value: float,
                track: str = "dispatch") -> None:
        pass

    def span(self, name: str, track: str = "dispatch", **args: Any):
        return _NULL_SPAN

    def events(self) -> List[Tuple]:
        return []

    def to_chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


#: the shared disabled sink — the default ``tracer=`` everywhere
NULL_TRACER = NullTracer()


class Tracer:
    """Thread-safe bounded event tracer (see module docstring).

    Events are stored as ``(ph, name, track, ts, dur, event_id, args)``
    tuples in a ring buffer of ``capacity`` entries; ``dropped`` counts
    ring evictions.  ``ts`` is in *seconds* on the injected clock;
    export rebases to microseconds relative to the first retained event
    (Chrome wants non-negative ``ts``).
    """

    enabled = True

    def __init__(self, *, capacity: int = _DEFAULT_CAPACITY,
                 clock: Callable[[], float] = monotonic_clock,
                 process_name: str = "repro-serving"):
        if capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.clock = clock
        self.process_name = process_name
        self.dropped = 0
        self._events: deque = deque()
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------------

    def _push(self, ev: Tuple) -> None:
        with self._lock:
            if len(self._events) >= self.capacity:
                self._events.popleft()
                self.dropped += 1
            self._events.append(ev)

    def instant(self, name: str, track: str = "dispatch",
                **args: Any) -> None:
        """One point-in-time event ('i' phase)."""
        self._push(("i", name, track, self.clock(), None, None,
                    args or None))

    def begin(self, name: str, track: str, event_id: int,
              **args: Any) -> None:
        """Async begin ('b'): the matching :meth:`end` may come from a
        different thread — ``(name, track, event_id)`` pairs them."""
        self._push(("b", name, track, self.clock(), None, event_id,
                    args or None))

    def end(self, name: str, track: str, event_id: int,
            **args: Any) -> None:
        """Async end ('e') for the matching :meth:`begin`."""
        self._push(("e", name, track, self.clock(), None, event_id,
                    args or None))

    def counter(self, name: str, value: float,
                track: str = "dispatch") -> None:
        """A sampled counter series ('C' phase)."""
        self._push(("C", name, track, self.clock(), None, None,
                    {"value": value}))

    @contextmanager
    def span(self, name: str, track: str = "dispatch", **args: Any):
        """Complete-event bracket ('X' with duration): the body runs on
        one thread, begin-to-exit wall time on the injected clock."""
        t0 = self.clock()
        try:
            yield self
        finally:
            self._push(("X", name, track, t0, self.clock() - t0, None,
                        args or None))

    # -- reading -------------------------------------------------------------

    def events(self) -> List[Tuple]:
        """Snapshot of the retained ring, oldest first."""
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"events": len(self._events), "capacity": self.capacity,
                    "dropped": self.dropped}

    # -- export --------------------------------------------------------------

    def to_chrome_trace(self, *, pid: int = 1) -> Dict[str, Any]:
        """The Chrome Trace Event JSON object (``traceEvents`` array
        format) — loadable in Perfetto / ``chrome://tracing``.  Spans
        that began before the ring's oldest retained event are exported
        as-is (their async ends may be unmatched when ``dropped > 0``;
        :func:`validate_chrome_trace` treats a dropped trace as
        best-effort)."""
        evs = self.events()
        return chrome_trace_events(evs, pid=pid,
                                   process_name=self.process_name)

    def dump(self, path: str, *, pid: int = 1) -> None:
        """Write the Chrome trace JSON to ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(pid=pid), f)


def chrome_trace_events(events: List[Tuple], *, pid: int = 1,
                        process_name: str = "repro-serving"
                        ) -> Dict[str, Any]:
    """Convert recorded ``(ph, name, track, ts, dur, id, args)`` tuples
    into the Chrome Trace Event JSON object.  Timestamps rebase to
    microseconds relative to the earliest retained event, so ``ts`` is
    always non-negative; tracks become ``tid`` rows named by metadata
    events.

    Events are emitted sorted by timestamp: ring order is *push* order,
    and a cross-thread async pair (begin on the dispatcher, end on the
    completer) can be pushed out of timestamp order under thread
    scheduling.  The sort is stable, and a begin is always pushed before
    its matching end, so equal-timestamp pairs stay ordered."""
    events = sorted(events, key=lambda ev: ev[3])
    tids: Dict[str, int] = {t: i for i, t in enumerate(TRACKS)}
    for ev in events:
        tids.setdefault(ev[2], len(tids))
    t0 = min((ev[3] for ev in events), default=0.0)
    out: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": process_name}}]
    for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": track}})
        out.append({"ph": "M", "name": "thread_sort_index", "pid": pid,
                    "tid": tid, "args": {"sort_index": tid}})
    for ph, name, track, ts, dur, event_id, args in events:
        rec: Dict[str, Any] = {
            "ph": ph, "name": name, "cat": track,
            "ts": (ts - t0) * 1e6, "pid": pid, "tid": tids[track],
        }
        if dur is not None:
            rec["dur"] = dur * 1e6
        if event_id is not None:
            rec["id"] = event_id
        if args:
            rec["args"] = args
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def validate_chrome_trace(trace: Dict[str, Any], *,
                          require_tracks: Tuple[str, ...] = ()
                          ) -> List[str]:
    """Schema-check a Chrome trace object; returns a list of problems
    (empty == valid).  Checked: the ``traceEvents`` envelope, known
    phases, non-negative finite ``ts`` monotone per track (complete
    events carry non-negative ``dur``), async begin/end pairs matched
    per ``(cat, name, id)``, and — when ``require_tracks`` names rows —
    that each is present with at least one event."""
    problems: List[str] = []
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    track_names: Dict[int, str] = {}
    for ev in evs:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            track_names[ev.get("tid")] = ev.get("args", {}).get("name")
    last_ts: Dict[Tuple[int, int], float] = {}
    open_async: Dict[Tuple[str, str, Any], int] = {}
    seen_tracks: Dict[str, int] = {}
    for i, ev in enumerate(evs):
        ph = ev.get("ph")
        if ph not in ("M", "X", "i", "b", "e", "C"):
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0 or ts != ts:
            problems.append(f"event {i} ({ev.get('name')}): bad ts {ts!r}")
            continue
        key = (ev.get("pid"), ev.get("tid"))
        if ts < last_ts.get(key, 0.0) - 1e-6:
            problems.append(
                f"event {i} ({ev.get('name')}): ts {ts} went backwards "
                f"on track {track_names.get(ev.get('tid'), ev.get('tid'))}")
        last_ts[key] = max(last_ts.get(key, 0.0), ts)
        track = ev.get("cat") or track_names.get(ev.get("tid"))
        if track:
            seen_tracks[track] = seen_tracks.get(track, 0) + 1
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(
                    f"event {i} ({ev.get('name')}): bad dur {dur!r}")
        elif ph == "b":
            k = (ev.get("cat"), ev.get("name"), ev.get("id"))
            open_async[k] = open_async.get(k, 0) + 1
        elif ph == "e":
            k = (ev.get("cat"), ev.get("name"), ev.get("id"))
            if open_async.get(k, 0) <= 0:
                problems.append(
                    f"event {i}: async end without begin for {k}")
            else:
                open_async[k] -= 1
    for k, n in open_async.items():
        if n:
            problems.append(f"async begin without end for {k} (x{n})")
    for t in require_tracks:
        if not seen_tracks.get(t):
            problems.append(f"required track {t!r} has no events")
    return problems
