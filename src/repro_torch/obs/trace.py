"""Host-side spans, counters and Chrome-trace export (the port of the
JAX package's ``obs/trace.py``, with two sinks more).

:func:`span` is the program's one timer.  A span has three sinks, each
on where it applies:

* **the profiler** — while ``torch.profiler`` records, every span
  enters ``torch.profiler.record_function(name)``, so the card's
  kernels and the profiler's idle gaps line up under the program's own
  names, whether or not the layer below is on;
* **a ``seconds`` dict** — given one, the span adds its host seconds
  under its name (two ``perf_counter`` reads), always: this is how
  ``PeelResult.seconds`` and the peel CLI's ``seconds`` are filled;
* **the Tracer** — with the observability layer on (``enable()``) a
  :class:`Tracer` records the span as a Chrome-trace event, unless the
  span was opened with ``event=False`` (the sub-step spans below, which
  keep the Tracer's output event for event equal to the JAX
  package's).

With none of them on, ``span()`` returns a shared null object.  A span
yields the Tracer event's late-args dict where it writes one, else
``None``.  One module-level switch (``enable()`` / ``disable()``) gates
the Tracer and the FD drivers' rings: with it off (the default) the FD
drivers pick a zero ring capacity, so no ring tensor is allocated and no
telemetry twin runs — θ, ``PeelStats`` and the kernels' launch counts
are those of a run without the layer.

With it on, a :class:`Tracer` records nested spans (Chrome-trace
"complete" events, ``ph="X"``), instants (``ph="i"``) and counter
samples (``ph="C"``) with categories and JSON-able args, timestamped in
microseconds since the Unix epoch (``time.time_ns()`` at the tracer's
creation plus ``perf_counter`` offsets, so they stay monotonic) — the
base of a ``torch.profiler`` Chrome export once its
``baseTimeNanoseconds`` is added, so the two traces line up.
``save()`` writes the standard ``{"traceEvents": [...]}`` envelope,
loadable in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

Besides, :func:`count` keeps process-wide event counts, always on (read
with :func:`counts`, beside ``kernels.ops.launch_counts()``), and
:func:`gc_pauses` sums the cyclic GC's pauses into a ``seconds`` dict
while a block runs.

Span taxonomy (sinks: P the profiler, S a ``seconds`` dict, T the
Tracer):

=====================  ==========  =====  ===================================
name / cat             ph          sinks  meaning
=====================  ==========  =====  ===================================
``peel``               X           P T    one ``decompose()`` run
``cd``                 X           P S T  Phase 1 (cover decomposition)
                                          total; ``seconds["cd"]``
``cd.round``           X           P T    one masked peel round; count ==
                                          ``rho_cd``
``fd``                 X           P S T  Phase 2 (fine decomposition)
                                          total; ``seconds["fd"]``
``fd.launch``          X           P T    one FD dispatch (a partition, or
                                          the one vmapped/fused loop
                                          covering all of them)
``fd.round``           i           T      one partition-round; count ==
                                          rho_fd_total
``hierarchy``          X           P T    hierarchy build / repair steps
``stream``             X           P T    one streaming epoch and its CD /
                                          FD / repair steps
``spec.wedges``        —           P S    ``csr.build_wedges`` of a csr spec
                                          (0 where the wedges are passed in)
``spec.supports``      —           P S    the ⋈init supports (csr: pair
                                          butterflies, workloads, vertex or
                                          edge counts, slot packs; beindex:
                                          ``edge_support``, bloom numbers;
                                          dense: the first count)
``spec.beindex``       —           P S    ``build_beindex`` of the beindex
                                          spec, on the spec's device: the
                                          CSR and labels, the wedge-slot
                                          enumeration, the bloom sorts
                                          and the download of the four
                                          arrays
``spec.upload``        —           P S    the spec's copies to the device
``fd.pack``            —           P S    an FD driver's preparation of its
                                          partition arrays and their
                                          copies to the device (on the
                                          device for ``fd_wing_beindex``)
``graph.from_edges``   —           P S    ``BipartiteGraph.from_edges``
                                          (its seconds travel with the
                                          graph; the peel CLI's
                                          ``seconds["graph"]``)
``peel.summary``       —           P S    the peel CLI's θ digest, levels
                                          and summary lines
``run``                —           P S    the whole of the peel CLI's
                                          ``run()``
=====================  ==========  =====  ===================================

Counters (:func:`counts`): ``peel.decompositions``, one a
``decompose()``; ``fd.host_syncs``, every read from the device to the
host that the FD drivers make (the drained-flag reads of the device
loops, the host cascades' support and update-count reads, the rounds,
update counts and θ read back after each dispatch, and the one read
after a ``fd_tip_dense`` or ``fd_wing_beindex`` launch, with one more
of its round records while a timeline collector is live).
"""
from __future__ import annotations

import collections
import gc
import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from torch.autograd import _profiler_enabled
from torch.profiler import record_function as _record_function

__all__ = [
    "Tracer", "enable", "disable", "enabled", "get_tracer",
    "span", "instant", "counter", "count", "counts", "reset_counts",
    "gc_pauses",
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


class _Span:
    """A span with a sink besides the Tracer's: ``inner`` (a Tracer span,
    a ``record_function`` or ``None``) around the block, and its host
    seconds added to ``seconds[name]`` where ``seconds`` is a dict.
    Yields what a Tracer span yields, else ``None``."""
    __slots__ = ("_inner", "_traced", "_name", "_seconds", "_t0")

    def __init__(self, inner, traced: bool, name: str,
                 seconds: Optional[Dict[str, float]]) -> None:
        self._inner = inner
        self._traced = traced
        self._name = name
        self._seconds = seconds
        self._t0 = 0.0

    def __enter__(self):
        late = self._inner.__enter__() if self._inner is not None else None
        self._t0 = time.perf_counter()
        return late if self._traced else None

    def __exit__(self, *exc):
        if self._seconds is not None:
            self._seconds[self._name] = (self._seconds.get(self._name, 0.0)
                                         + time.perf_counter() - self._t0)
        if self._inner is not None:
            return self._inner.__exit__(*exc)
        return False


class Tracer:
    """Records Chrome-trace events; timestamps are microseconds since
    the Unix epoch (Chrome-trace native unit): ``time.time_ns()`` when
    the tracer was created plus ``perf_counter`` offsets."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self._epoch_us = time.time_ns() / 1e3
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []

    # -- recording ---------------------------------------------------
    def now(self) -> float:
        """Microseconds since the Unix epoch."""
        return self._epoch_us + (time.perf_counter() - self._t0) * 1e6

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
# serving layer routes through these helpers so the off path costs an
# ``is None`` check and a read of the profiler's state (two clock reads
# more for a span with a ``seconds`` dict) and changes no traced program.
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


def span(name: str, cat: str = "", *, seconds: Optional[dict] = None,
         event: bool = True, **args: Any):
    """A span around the block, into each sink that is on: the Tracer
    (with the layer on, unless ``event`` is false), ``torch.profiler``
    (while it records) and ``seconds`` (where given, always: its host
    seconds added under ``name``).  The shared null span when none is."""
    t = _tracer if event else None
    if t is not None:
        inner = t.span(name, cat, **args)
        return inner if seconds is None else _Span(inner, True, name,
                                                   seconds)
    if _profiler_enabled():
        return _Span(_record_function(name), False, name, seconds)
    if seconds is None:
        return _NULL_SPAN
    return _Span(None, False, name, seconds)


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


# ----------------------------------------------------------------------
# Process-wide event counts, always on (the layer's switch does not gate
# them), and the cyclic GC's pauses.
# ----------------------------------------------------------------------
_COUNTS: collections.Counter = collections.Counter()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide count ``name``."""
    _COUNTS[name] += n


def counts() -> Dict[str, int]:
    """The process-wide counts, by name."""
    return dict(_COUNTS)


def reset_counts() -> None:
    """Set every count to 0."""
    _COUNTS.clear()


@contextmanager
def gc_pauses(seconds: dict) -> Iterator[None]:
    """Add the host seconds of every cyclic GC collection that runs
    inside the block to ``seconds["gc"]`` (set to 0 first where absent),
    through a ``gc.callbacks`` hook removed on exit."""
    seconds.setdefault("gc", 0.0)
    start = [0.0]

    def hook(phase: str, info: dict) -> None:
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            seconds["gc"] += time.perf_counter() - start[0]

    gc.callbacks.append(hook)
    try:
        yield
    finally:
        gc.callbacks.remove(hook)
