"""Serving metrics: counters, gauges and fixed-bucket latency
histograms with a JSON snapshot exporter (a copy of the JAX package's
``obs/metrics.py``; its snapshots are held equal to the original's by
``tests/test_torch_obs.py``).

Registries are **per-instance** (a ``StreamState`` owns one) so tests
never fight over global state.

Histograms use fixed geometric buckets (default 1 µs … ~67 s in ×2
steps, values in milliseconds) — constant memory per metric, p50/p99
read back by linear interpolation inside the owning bucket.  For exact
percentiles over raw samples, use :func:`percentiles`.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "percentiles",
]

# bucket upper bounds in ms: 0.001, 0.002, ... ~67_000 (2**26 µs)
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    0.001 * (2.0 ** i) for i in range(27))


class Counter:
    """Monotonic event count."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        """Add ``n`` events."""
        self.value += int(n)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able state dict."""
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        """Overwrite the current value."""
        self.value = float(v)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able state dict."""
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket latency histogram (record values in ms)."""

    def __init__(self, buckets: Optional[Sequence[float]] = None) -> None:
        self.bounds = np.asarray(buckets if buckets is not None
                                 else DEFAULT_BUCKETS, np.float64)
        self.counts = np.zeros(self.bounds.shape[0] + 1, np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def record(self, v: float) -> None:
        """Add one observation (milliseconds)."""
        v = float(v)
        self.counts[int(np.searchsorted(self.bounds, v, side="left"))] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def percentile(self, p: float) -> float:
        """Approximate percentile: linear interpolation inside the
        bucket holding rank ``p``; clamped to the observed min/max."""
        if self.count == 0:
            return 0.0
        rank = (p / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = (self.bounds[i] if i < self.bounds.shape[0]
                      else self.max)
                frac = (rank - cum) / c
                v = lo + (hi - lo) * frac
                return float(min(max(v, self.min), self.max))
            cum += c
        return self.max

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able summary: count/sum/mean/min/max + p50/p99 (ms)."""
        if self.count == 0:
            return {"type": "histogram", "count": 0}
        return {"type": "histogram", "count": self.count,
                "sum_ms": self.sum, "mean_ms": self.sum / self.count,
                "min_ms": self.min, "max_ms": self.max,
                "p50_ms": self.percentile(50.0),
                "p99_ms": self.percentile(99.0)}


class MetricsRegistry:
    """Named counters/gauges/histograms with get-or-create semantics."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(*args)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is {type(m).__name__}, "
                    f"not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        """Get-or-create the named counter."""
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        """Get-or-create the named gauge."""
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """Get-or-create the named histogram."""
        return self._get(name, Histogram, buckets)

    # convenience one-liners for instrumentation sites
    def inc(self, name: str, n: int = 1) -> None:
        """Increment the named counter by ``n``."""
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        """Set the named gauge to ``v``."""
        self.gauge(name).set(v)

    def observe(self, name: str, ms: float) -> None:
        """Record ``ms`` into the named histogram."""
        self.histogram(name).record(ms)

    def get(self, name: str):
        """The named metric object, or ``None``."""
        return self._metrics.get(name)

    def snapshot(self) -> Dict[str, Any]:
        """Name-sorted dict of every metric's snapshot."""
        with self._lock:
            return {name: m.snapshot()
                    for name, m in sorted(self._metrics.items())}

    def save(self, path: str) -> None:
        """Write :meth:`snapshot` as indented JSON to ``path``."""
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)


def percentiles(samples: Iterable[float],
                ps: Sequence[float] = (50.0, 99.0)) -> Dict[str, float]:
    """Exact percentiles over raw samples: ``{"p50": ..., "p99": ...}``."""
    arr = np.asarray(list(samples), np.float64)
    if arr.size == 0:
        return {f"p{g:g}": 0.0 for g in ps}
    return {f"p{g:g}": float(np.percentile(arr, g)) for g in ps}
