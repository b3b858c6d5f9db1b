"""Structured observability for the port's peel-to-serve stack (the
port of the JAX package's ``repro.obs``).

Three parts:

* ``obs.trace``  — host-side span recorder with Chrome-trace export
  (Perfetto-loadable), its spans bridged to
  ``torch.profiler.record_function``;
* ``obs.timeline`` — per-round peel timelines: CD rounds recorded live,
  FD rounds drained once per launch from int32 counter rings that the
  telemetry twins of the FD drivers write on the device;
* ``obs.metrics`` — counters / gauges / fixed-bucket latency histograms
  (p50/p99), with a JSON snapshot exporter.

The whole layer is gated by :func:`enable` / :func:`disable`.  **Off
(the default) changes nothing**: no ring tensor is allocated and no
``*_rings`` twin runs, so θ, ``PeelStats`` and the kernels' launch
counts equal a run without the layer (``tests/test_torch_obs.py``).

Set ``REPRO_OBS=1`` to enable at import time, and ``REPRO_OBS_RING_CAP``
to size the per-round FD rings (default 1024) — the JAX package's
variables.  The state (tracer, collector) is this package's own.
"""
from __future__ import annotations

import os as _os

from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, percentiles)
from .timeline import (PeelTimeline, TimelineCollector,  # noqa: F401
                       RING_CAP_DEFAULT, fd_ring_cap, maybe_collect)
from .timeline import active as active_collector  # noqa: F401
from .trace import (Tracer, counter, disable, enable,  # noqa: F401
                    enabled, get_tracer, instant, span)

__all__ = [
    "Tracer", "enable", "disable", "enabled", "get_tracer",
    "span", "instant", "counter",
    "PeelTimeline", "TimelineCollector", "RING_CAP_DEFAULT",
    "fd_ring_cap", "maybe_collect", "active_collector",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "percentiles",
]

if _os.environ.get("REPRO_OBS", "") in ("1", "true", "yes"):
    enable()
