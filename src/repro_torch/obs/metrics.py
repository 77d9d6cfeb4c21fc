"""Labelled histogram registry with a ``snapshot()`` dict.

The part of the JAX package's ``obs/metrics.py`` that ``compile()`` uses:
each pass records its wall seconds into the process-wide
:func:`default_registry` as ``compile_pass_seconds{pass=<name>}``.

  * :class:`Histogram` — exact ``count``/``sum``/``min``/``max`` over
    the full lifetime plus nearest-rank percentiles over a bounded
    window of the most recent ``window`` observations.

Instruments are identified by ``(name, sorted labels)``; getting an
existing key returns the SAME instrument, so call sites never cache
handles.  All operations are thread-safe.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Dict, Optional

__all__ = ["Histogram", "MetricsRegistry", "default_registry"]


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


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
    """Get-or-create registry of histograms; ``snapshot()`` returns a
    JSON-safe dict suitable for report embedding."""

    def __init__(self, *, histogram_window: int = 1024):
        self.histogram_window = histogram_window
        self._create = threading.Lock()
        self._histograms: Dict[str, Histogram] = {}

    def histogram(self, name: str, **labels: Any) -> Histogram:
        key = _key(name, labels)
        with self._create:
            got = self._histograms.get(key)
            if got is None:
                got = self._histograms[key] = Histogram(
                    key, threading.Lock(), self.histogram_window)
            return got

    def snapshot(self) -> Dict[str, Any]:
        """``{"histograms": {key: summary}}``."""
        with self._create:
            hists = list(self._histograms.values())
        return {"histograms": {h.key: h.summary() for h in hists}}


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry for producers with no engine to own a
    registry (``compile()`` pass timings)."""
    return _DEFAULT
