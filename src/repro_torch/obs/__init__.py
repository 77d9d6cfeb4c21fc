"""Metrics the compiler records (per-pass wall seconds)."""
from repro_torch.obs.metrics import (Histogram,  # noqa: F401
                                     MetricsRegistry, default_registry)
