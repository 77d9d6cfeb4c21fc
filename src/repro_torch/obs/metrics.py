"""Labelled counter/gauge/histogram registry with a ``snapshot()`` dict.

The numeric companion to :mod:`repro_torch.obs.trace`: where the tracer
answers *when* (a timeline of one serving interval), the registry
answers *how much* (monotone totals, point-in-time levels, bounded
distributions) — cheap enough to stay always-on, serializable as one
plain dict so reports and benchmark artifacts can embed it.

  * :class:`Counter` — monotone float total (``inc``);
  * :class:`Gauge` — last-write-wins level (``set``/``inc``);
  * :class:`Histogram` — exact ``count``/``sum``/``min``/``max`` over
    the full lifetime plus nearest-rank percentiles over a bounded
    window of the most recent ``window`` observations (a long-lived
    server must not grow without bound — same policy as the serving
    engines' METRIC_WINDOW deques).

Instruments are identified by ``(name, sorted labels)``; getting an
existing key returns the SAME instrument, so call sites never cache
handles.  All operations are thread-safe.  Registries are cheap — each
serving engine owns its own, so ``snapshot()`` is engine-local; the
module-level :func:`default_registry` collects cross-cutting compiler
timings (``compile()`` per-pass wall seconds, trace-cache state) where
no engine exists to own them.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry"]


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotone total."""

    def __init__(self, key: str, lock: threading.Lock):
        self.key = key
        self._lock = lock
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"{self.key}: counters only go up (inc {n})")
        with self._lock:
            self.value += n


class Gauge:
    """Point-in-time level (last write wins)."""

    def __init__(self, key: str, lock: threading.Lock):
        self.key = key
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Exact lifetime aggregates + percentiles over a bounded window."""

    def __init__(self, key: str, lock: threading.Lock, window: int = 1024):
        if window < 1:
            raise ValueError(f"histogram window must be >= 1, got {window}")
        self.key = key
        self._lock = lock
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._window: deque = deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            raise ValueError(f"{self.key}: observe(nan)")
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self._window.append(v)

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the retained window."""
        with self._lock:
            win = sorted(self._window)
        if not win:
            return 0.0
        return win[max(0, math.ceil(p * len(win)) - 1)]

    def summary(self) -> Dict[str, float]:
        with self._lock:
            win = sorted(self._window)
            out = {"count": self.count, "sum": self.sum,
                   "min": self.min if self.min is not None else 0.0,
                   "max": self.max if self.max is not None else 0.0,
                   "window": len(win)}
        for p, tag in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            out[tag] = win[max(0, math.ceil(p * len(win)) - 1)] \
                if win else 0.0
        return out


class MetricsRegistry:
    """Get-or-create registry over the three instrument kinds.  One lock
    per instrument (shared creation lock for the maps); ``snapshot()``
    returns a JSON-safe dict suitable for report embedding."""

    def __init__(self, *, histogram_window: int = 1024):
        self.histogram_window = histogram_window
        self._create = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str, **labels: Any) -> Counter:
        key = _key(name, labels)
        with self._create:
            got = self._counters.get(key)
            if got is None:
                got = self._counters[key] = Counter(key, threading.Lock())
            return got

    def gauge(self, name: str, **labels: Any) -> Gauge:
        key = _key(name, labels)
        with self._create:
            got = self._gauges.get(key)
            if got is None:
                got = self._gauges[key] = Gauge(key, threading.Lock())
            return got

    def histogram(self, name: str, **labels: Any) -> Histogram:
        key = _key(name, labels)
        with self._create:
            got = self._histograms.get(key)
            if got is None:
                got = self._histograms[key] = Histogram(
                    key, threading.Lock(), self.histogram_window)
            return got

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-safe dict of everything:
        ``{"counters": {key: total}, "gauges": {key: level},
        "histograms": {key: summary}}``."""
        with self._create:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        return {
            "counters": {c.key: c.value for c in counters},
            "gauges": {g.key: g.value for g in gauges},
            "histograms": {h.key: h.summary() for h in hists},
        }


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry for cross-cutting producers with no
    engine to own a registry (``compile()`` pass timings, trace-cache
    instrumentation)."""
    return _DEFAULT
