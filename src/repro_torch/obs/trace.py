"""Host-side span tracing with Chrome-trace export (the port of the JAX
package's ``obs/trace.py``).

One module-level switch (``enable()`` / ``disable()``) gates the whole
observability layer: with it off (the default) every ``span()`` /
``instant()`` call returns a shared null object and the FD drivers pick
a zero ring capacity, so no ring tensor is allocated and no telemetry
twin runs — θ, ``PeelStats`` and the kernels' launch counts are those of
a run without the layer.

With it on, a :class:`Tracer` records nested spans (Chrome-trace
"complete" events, ``ph="X"``), instants (``ph="i"``) and counter
samples (``ph="C"``) with categories and JSON-able args.  ``save()``
writes the standard ``{"traceEvents": [...]}`` envelope, loadable in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.  Host spans
also enter ``torch.profiler.record_function`` so the card's kernels line
up under them when a ``torch.profiler`` trace is being captured at the
same time.

Span taxonomy:

====================  ==========  ===========================================
cat                   ph          meaning
====================  ==========  ===========================================
``peel``              X           one ``decompose()`` run
``cd``                X           Phase 1 (cover decomposition) total
``cd.round``          X           one masked peel round; count == ``rho_cd``
``fd``                X           Phase 2 (fine decomposition) total
``fd.launch``         X           one FD dispatch (a partition, or the one
                                  vmapped/fused loop covering all of them)
``fd.round``          i           one partition-round; count == rho_fd_total
``hierarchy``         X           hierarchy build / repair steps
``stream``            X           one streaming epoch and its CD / FD /
                                  repair steps
====================  ==========  ===========================================
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from torch.profiler import record_function as _record_function

__all__ = [
    "Tracer", "enable", "disable", "enabled", "get_tracer",
    "span", "instant", "counter",
]


def _jsonable(v: Any) -> Any:
    """Coerce numpy scalars / arrays into plain JSON values."""
    if isinstance(v, (str, bool)) or v is None:
        return v
    if hasattr(v, "tolist"):          # numpy scalar or array
        return v.tolist()
    if isinstance(v, (int, float)):
        return v
    return str(v)


class _NullSpan:
    """Context manager returned when tracing is disabled."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Records Chrome-trace events; timestamps are microseconds since
    the tracer was created (Chrome-trace native unit)."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []

    # -- recording ---------------------------------------------------
    def now(self) -> float:
        """Microseconds since tracer start."""
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, cat: str = "",
             **args: Any) -> Iterator[Dict[str, Any]]:
        """Record a complete event around the block.  Yields a dict the
        block may fill with late args (values only known mid-span, e.g.
        a round's update delta) — merged into the event at exit."""
        t0 = self.now()
        late: Dict[str, Any] = {}
        try:
            with _record_function(name):
                yield late
        finally:
            args.update(late)
            ev: Dict[str, Any] = dict(
                name=name, cat=cat or name, ph="X", ts=t0,
                dur=self.now() - t0, pid=0, tid=0)
            if args:
                ev["args"] = {k: _jsonable(v) for k, v in args.items()}
            with self._lock:
                self.events.append(ev)

    def instant(self, name: str, cat: str = "",
                ts: Optional[float] = None, **args: Any) -> None:
        """Record a zero-duration event (Chrome-trace ``ph="i"``)."""
        ev: Dict[str, Any] = dict(
            name=name, cat=cat or name, ph="i", s="t",
            ts=self.now() if ts is None else ts, pid=0, tid=0)
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            self.events.append(ev)

    def counter(self, name: str, values: Dict[str, Any],
                ts: Optional[float] = None) -> None:
        """A counter-track sample (renders as a curve in Perfetto)."""
        ev = dict(name=name, cat=name, ph="C",
                  ts=self.now() if ts is None else ts, pid=0, tid=0,
                  args={k: _jsonable(v) for k, v in values.items()})
        with self._lock:
            self.events.append(ev)

    # -- queries (used by the trace/stats exact-match tests) ---------
    def spans(self, cat: Optional[str] = None,
              ph: Optional[str] = None) -> List[Dict[str, Any]]:
        """Events filtered by category and/or phase."""
        return [e for e in self.events
                if (cat is None or e.get("cat") == cat)
                and (ph is None or e.get("ph") == ph)]

    def count(self, cat: Optional[str] = None,
              ph: Optional[str] = None) -> int:
        """Number of events matching the category/phase filter."""
        return len(self.spans(cat, ph))

    def sum_arg(self, key: str, cat: Optional[str] = None) -> int:
        """Sum an integer arg over every matching event."""
        return sum(int(e.get("args", {}).get(key, 0))
                   for e in self.spans(cat))

    # -- export ------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """The standard Chrome-trace envelope (Perfetto-loadable)."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        """Write :meth:`to_chrome` as JSON to ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


# ----------------------------------------------------------------------
# Module-level gate.  ALL instrumentation in the peel core / hierarchy /
# serving layer routes through these helpers so the off path costs one
# ``is None`` check and changes no traced program.
# ----------------------------------------------------------------------
_tracer: Optional[Tracer] = None


def enable() -> Tracer:
    """Turn the observability layer on; returns the active tracer
    (fresh on the first call, reused afterwards)."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer()
    return _tracer


def disable() -> None:
    """Turn the observability layer off and drop the tracer."""
    global _tracer
    _tracer = None


def enabled() -> bool:
    """Whether the observability layer is on."""
    return _tracer is not None


def get_tracer() -> Optional[Tracer]:
    """The active tracer, or ``None`` when the layer is off."""
    return _tracer


def span(name: str, cat: str = "", **args: Any):
    """Module-level :meth:`Tracer.span`; inert null span when off."""
    t = _tracer
    return t.span(name, cat, **args) if t is not None else _NULL_SPAN


def instant(name: str, cat: str = "", **args: Any) -> None:
    """Module-level :meth:`Tracer.instant`; no-op when off."""
    t = _tracer
    if t is not None:
        t.instant(name, cat, **args)


def counter(name: str, values: Dict[str, Any]) -> None:
    """Module-level :meth:`Tracer.counter`; no-op when off."""
    t = _tracer
    if t is not None:
        t.counter(name, values)
