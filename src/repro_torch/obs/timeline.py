"""Per-round peel timelines: the paper's "work per round" curves as a
first-class output (the port of the JAX package's ``obs/timeline.py``;
the classes and the drain are a copy, held equal to the original by
``tests/test_torch_obs.py``).

Two sources feed a :class:`PeelTimeline`:

* **CD rounds** are host-driven (``peelspec.cd_loop``), so each round is
  recorded directly: partition id, dying-entity count, frontier size,
  the level's upper bound ``hi`` and the update/recount deltas charged
  by ``cd_step``.

* **FD rounds** of the device, vmapped and fused drivers are queued on
  the device in chunks and never read by the host inside a round.  The
  telemetry-on twins of those drivers (``peelspec._fd_while_*_rings``)
  write preallocated int32 **counter rings** on the device — per-round
  dying count, frontier size, k-advance and update count, at row
  ``min(round, cap-1)``, masked off for the rounds queued past the
  fixed point — and the entity wrappers drain them here once, after the
  loop.  Ring capacity comes from ``fd_ring_cap()``: 0 whenever the obs
  layer is off (the default path allocates no ring and calls no twin),
  else ``REPRO_OBS_RING_CAP`` (default 1024).  Cascades longer than the
  cap keep their first ``cap-1`` rounds plus the final round and are
  flagged ``truncated``.  The host driver and the dense and beindex
  engines record each round directly (``record_fd_host``).

The collector is installed by ``peelspec.decompose`` via
``maybe_collect()``; the resulting timeline is attached to
``PeelResult.timeline`` and summarized into artifact provenance.  This
module's state (the active collector) is the port's own: enabling the
JAX package's layer changes nothing here, and the reverse.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import trace

__all__ = [
    "PeelTimeline", "TimelineCollector", "maybe_collect", "active",
    "fd_ring_cap", "RING_CAP_DEFAULT",
]

RING_CAP_DEFAULT = 1024

_CD_KEYS = ("part", "died", "frontier", "hi", "updates", "recounts")


@dataclass
class PeelTimeline:
    """Per-round curves for one decomposition run.

    ``cd``: dict of equal-length int64 arrays (one entry per CD round):
    ``part, died, frontier, hi, updates, recounts``.

    ``fd``: one dict per FD launch::

        {"mode": "device"|"vmapped"|"fused"|"host",
         "parts": [int, ...],          # partitions covered (len B)
         "rounds": [int, ...],         # per-partition round count (len B)
         "died": (T, B) int array,     # per recorded iteration
         "frontier": (T, B) int array,
         "k": (T, B) int array,
         "updates": (T,) int array | None,  # per-iteration totals
         "truncated": bool}

    ``T = min(max(rounds), ring capacity)`` — iterations actually
    captured in the rings.
    """
    cd: Dict[str, np.ndarray]
    fd: List[Dict[str, Any]] = field(default_factory=list)

    # -- totals (the exact-match oracle against PeelStats) -----------
    @property
    def cd_rounds(self) -> int:
        """Number of CD rounds (== ``PeelStats.rho_cd``)."""
        return int(self.cd["part"].shape[0])

    def fd_rounds_total(self) -> int:
        """Summed per-partition FD rounds (== ``rho_fd_total``)."""
        return int(sum(sum(L["rounds"]) for L in self.fd))

    def fd_rounds_max(self) -> int:
        """Longest single-partition cascade (the FD critical path)."""
        return int(max((max(L["rounds"], default=0) for L in self.fd),
                       default=0))

    def updates_total(self) -> int:
        """CD + FD support updates, where launches recorded them."""
        tot = int(self.cd["updates"].sum())
        for L in self.fd:
            if L.get("updates") is not None:
                tot += int(np.sum(L["updates"]))
        return tot

    def truncated(self) -> bool:
        """Whether any launch's cascade overflowed its ring."""
        return any(L.get("truncated") for L in self.fd)

    # -- (de)serialization -------------------------------------------
    def as_dict(self) -> Dict[str, Any]:
        """Pure-JSON form (inverse of :meth:`from_dict`)."""
        return {
            "cd": {k: np.asarray(v).tolist() for k, v in self.cd.items()},
            "fd": [{**L,
                    "died": np.asarray(L["died"]).tolist(),
                    "frontier": np.asarray(L["frontier"]).tolist(),
                    "k": np.asarray(L["k"]).tolist(),
                    "updates": (None if L.get("updates") is None
                                else np.asarray(L["updates"]).tolist())}
                   for L in self.fd],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PeelTimeline":
        """Rebuild from :meth:`as_dict` output."""
        cd = {k: np.asarray(d["cd"][k], np.int64) for k in _CD_KEYS}
        fd = []
        for L in d.get("fd", []):
            fd.append({**L,
                       "died": np.asarray(L["died"], np.int64),
                       "frontier": np.asarray(L["frontier"], np.int64),
                       "k": np.asarray(L["k"], np.int64),
                       "updates": (None if L.get("updates") is None else
                                   np.asarray(L["updates"], np.int64))})
        return cls(cd=cd, fd=fd)

    def summary(self) -> Dict[str, Any]:
        """Compact JSON-able digest for artifact provenance."""
        return {
            "cd_rounds": self.cd_rounds,
            "fd_launches": len(self.fd),
            "fd_rounds_total": self.fd_rounds_total(),
            "fd_rounds_max": self.fd_rounds_max(),
            "cd_died_max": int(self.cd["died"].max(initial=0)),
            "truncated": self.truncated(),
        }

    # -- trace integration -------------------------------------------
    def emit_trace_events(self, tracer: "trace.Tracer") -> None:
        """Synthesize per-round trace events from the drained rings.

        CD rounds were recorded as live ``cd.round`` spans already; this
        adds (a) a ``peel.cd`` counter track sampled at each of those
        spans' end timestamps and (b) one ``fd.round`` instant per
        partition-round (count == ``PeelStats.rho_fd_total``) carrying
        died/frontier/k args where the ring captured that iteration.
        """
        cd_spans = sorted(tracer.spans("cd.round"), key=lambda e: e["ts"])
        for j in range(self.cd_rounds):
            ts = (cd_spans[j]["ts"] + cd_spans[j]["dur"]
                  if j < len(cd_spans) else tracer.now())
            tracer.counter("peel.cd", {
                "died": int(self.cd["died"][j]),
                "frontier": int(self.cd["frontier"][j])}, ts=ts)
        for L in self.fd:
            base = tracer.now()
            T = int(np.asarray(L["died"]).shape[0])
            for b, (p, r) in enumerate(zip(L["parts"], L["rounds"])):
                for t in range(int(r)):
                    args: Dict[str, Any] = {"part": int(p), "round": t}
                    if t < T:
                        args.update(
                            died=int(L["died"][t][b]),
                            frontier=int(L["frontier"][t][b]),
                            k=int(L["k"][t][b]))
                    tracer.instant("fd.round", cat="fd.round",
                                   ts=base + t, **args)


class TimelineCollector:
    """Accumulates CD rows and drained FD rings during one run."""

    def __init__(self) -> None:
        self.cd_rows: List[Dict[str, int]] = []
        self.fd_launches: List[Dict[str, Any]] = []

    # -- CD (host-driven, recorded live) -----------------------------
    def record_cd_round(self, part: int, died: int, frontier: int,
                        hi: int, updates: int, recounts: int) -> None:
        """Record one masked CD peel round (called from ``cd_loop``)."""
        self.cd_rows.append(dict(part=int(part), died=int(died),
                                 frontier=int(frontier), hi=int(hi),
                                 updates=int(updates),
                                 recounts=int(recounts)))

    # -- FD ring drains ----------------------------------------------
    def record_fd_rings(self, mode: str, parts: Sequence[int],
                        rounds: Sequence[int], rings: Any, cap: int,
                        cumulative_updates: bool = False) -> None:
        """Drain one launch's counter rings.

        ``rings`` is what a ``*_rings`` FD driver returns:
        ``(died, frontier, k, updates)`` host arrays shaped ``(cap,)``
        (device driver) or ``(cap, B)`` / ``(cap,)`` for the update ring
        (vmapped / fused).  ``cumulative_updates=True`` marks rings that
        store the running per-partition update total (the fused wing
        kernel's state carries cumulative ``nupd``); the drain converts
        them to per-iteration deltas.
        """
        died, frontier, k, upd = (np.asarray(r) for r in rings[:4])
        if died.ndim == 1:                       # device driver: B == 1
            died, frontier, k = (a[:, None] for a in (died, frontier, k))
            if upd.ndim == 1 and cumulative_updates:
                upd = upd[:, None]
        rounds = [int(r) for r in rounds]
        n = min(max(rounds, default=0), int(cap))
        died, frontier, k = died[:n], frontier[:n], k[:n]
        updates: Optional[np.ndarray]
        if cumulative_updates:
            per_part = np.diff(upd[:n], axis=0, prepend=0)
            updates = per_part.sum(axis=1).astype(np.int64)
        else:
            updates = upd[:n].astype(np.int64)
        self.fd_launches.append(dict(
            mode=mode, parts=[int(p) for p in parts], rounds=rounds,
            died=died.astype(np.int64), frontier=frontier.astype(np.int64),
            k=k.astype(np.int64), updates=updates,
            truncated=max(rounds, default=0) > int(cap)))

    def record_fd_counts(self, mode: str, parts: Sequence[int],
                         rounds: Sequence[int]) -> None:
        """A launch where only per-partition round counts are visible
        (the JAX package's sharded FD, whose rings do not cross the
        collective boundary).  Round totals stay exact; per-round
        died/frontier/k detail is absent (``T == 0``)."""
        rounds = [int(r) for r in rounds]
        z = np.zeros((0, len(list(parts))), np.int64)
        self.fd_launches.append(dict(
            mode=mode, parts=[int(p) for p in parts], rounds=rounds,
            died=z, frontier=z.copy(), k=z.copy(), updates=None,
            truncated=False))

    def record_fd_host(self, part: int, rows: List[Dict[str, int]],
                       updates: Optional[Sequence[int]] = None) -> None:
        """One host-driven cascade (``_fd_cascade`` / dense FD loops);
        ``rows`` carry died/frontier/k per round."""
        n = len(rows)
        self.fd_launches.append(dict(
            mode="host", parts=[int(part)], rounds=[n],
            died=np.array([[r["died"]] for r in rows], np.int64),
            frontier=np.array([[r["frontier"]] for r in rows], np.int64),
            k=np.array([[r["k"]] for r in rows], np.int64),
            updates=(None if updates is None
                     else np.asarray(updates, np.int64)),
            truncated=False))

    def build(self) -> PeelTimeline:
        """Assemble the collected rows into a :class:`PeelTimeline`."""
        cd = {k: np.array([r[k] for r in self.cd_rows], np.int64)
              for k in _CD_KEYS}
        return PeelTimeline(cd=cd, fd=list(self.fd_launches))


# ----------------------------------------------------------------------
# Active-collector plumbing.  ``decompose`` installs a collector for the
# duration of one run; the spec fd/cd functions look it up here instead
# of growing new callback parameters.
# ----------------------------------------------------------------------
_collector: Optional[TimelineCollector] = None


def active() -> Optional[TimelineCollector]:
    """The collector of the in-flight decomposition, or None when the
    obs layer is off / no run is collecting."""
    return _collector


@contextmanager
def maybe_collect() -> Iterator[Optional[TimelineCollector]]:
    """Install a fresh collector iff the obs layer is enabled; yields
    None (and changes nothing) otherwise."""
    global _collector
    if not trace.enabled():
        yield None
        return
    prev = _collector
    _collector = c = TimelineCollector()
    try:
        yield c
    finally:
        _collector = prev


def fd_ring_cap() -> int:
    """Ring capacity the FD entity wrappers should trace with: 0 unless
    a collector is live (so the default path never sees ring code)."""
    if _collector is None or not trace.enabled():
        return 0
    try:
        return max(int(os.environ.get("REPRO_OBS_RING_CAP",
                                      RING_CAP_DEFAULT)), 1)
    except ValueError:
        return RING_CAP_DEFAULT
