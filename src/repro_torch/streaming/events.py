"""Micro-epoch edge-event batching (streaming front door) — a copy of
the JAX package's ``streaming/events.py`` (pure numpy) on the port's own
``core/graph.py``, held equal to the original by
``tests/test_torch_streaming.py``.

Production bipartite traffic is a stream of (u, v) edge inserts and
deletes.  The streaming updater consumes them in *micro-epochs*: a
batch of events is coalesced against the current edge set — duplicate
and self-cancelling events collapse, already-present inserts and
absent deletes drop out — leaving the **net** insert/delete sets that
actually change the graph.  Everything downstream (support deltas,
dirty-partition detection, hierarchy repair) reasons about net sets
only, so an epoch whose events cancel out is a structural no-op and
the updater serves the previous decomposition unchanged.

Event traces are JSONL (``{"op": "+", "u": 3, "v": 7}`` per line) so
real traffic logs can be replayed through ``launch/stream.py``;
:func:`make_random_events` synthesizes one epoch's worth against a
live edge set for benchmarks and self-checks.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from ..core.graph import BipartiteGraph

__all__ = [
    "EdgeEvent",
    "coalesce",
    "apply_events",
    "load_trace",
    "save_trace",
    "make_random_events",
]


@dataclasses.dataclass(frozen=True)
class EdgeEvent:
    """One edge mutation: ``op`` is ``"+"`` (insert) or ``"-"`` (delete)."""

    op: str
    u: int
    v: int

    def __post_init__(self):
        if self.op not in ("+", "-"):
            raise ValueError(f"op must be '+' or '-', got {self.op!r}")


def coalesce(
    events: Sequence[EdgeEvent], g: BipartiteGraph
) -> Tuple[np.ndarray, np.ndarray]:
    """Net ``(inserts, deletes)`` of one micro-epoch against ``g``.

    Events apply in order, so the *last* event per edge key decides its
    desired presence; keys whose desired presence matches the current
    edge set drop out entirely.  Returns two ``(k, 2)`` int64 arrays in
    lexicographic key order (deterministic downstream processing)."""
    desired = {}
    for ev in events:
        if not (0 <= ev.u < g.n_u and 0 <= ev.v < g.n_v):
            raise ValueError(
                f"event ({ev.u}, {ev.v}) outside graph "
                f"({g.n_u} x {g.n_v})")
        desired[(ev.u, ev.v)] = ev.op == "+"
    if not desired:
        z = np.zeros((0, 2), dtype=np.int64)
        return z, z.copy()
    present = set(map(tuple, g.edges.tolist()))
    ins = sorted(k for k, want in desired.items() if want and k not in present)
    dels = sorted(k for k, want in desired.items()
                  if not want and k in present)
    to_arr = lambda ks: (np.asarray(ks, dtype=np.int64).reshape(-1, 2))  # noqa: E731
    return to_arr(ins), to_arr(dels)


def apply_events(
    g: BipartiteGraph, inserts: np.ndarray, deletes: np.ndarray
) -> BipartiteGraph:
    """The materialized graph after one coalesced micro-epoch."""
    if inserts.size == 0 and deletes.size == 0:
        return g
    edges = g.edges
    if deletes.size:
        codes = edges[:, 0].astype(np.int64) * g.n_v + edges[:, 1]
        dcodes = deletes[:, 0] * g.n_v + deletes[:, 1]
        edges = edges[~np.isin(codes, dcodes)]
    if inserts.size:
        edges = np.concatenate([edges, inserts.astype(np.int32)], axis=0)
    return BipartiteGraph.from_edges(g.n_u, g.n_v, edges)


# ---------------------------------------------------------------- trace IO
def load_trace(path: str) -> List[EdgeEvent]:
    """Load a JSONL event trace (one ``{"op", "u", "v"}`` per line)."""
    out: List[EdgeEvent] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append(EdgeEvent(str(d["op"]), int(d["u"]), int(d["v"])))
    return out


def save_trace(path: str, events: Iterable[EdgeEvent]) -> None:
    """Write events as a JSONL trace (inverse of :func:`load_trace`)."""
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(dict(op=ev.op, u=ev.u, v=ev.v)) + "\n")


def make_random_events(
    g: BipartiteGraph, n: int, seed: int = 0, p_delete: float = 0.3
) -> List[EdgeEvent]:
    """Synthesize one micro-epoch of events against the current graph.

    Deletes sample existing edges; inserts sample uniform (u, v) pairs
    (which may duplicate events or re-insert existing edges — the
    coalescer is expected to handle both).  Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    out: List[EdgeEvent] = []
    for _ in range(n):
        if g.m and rng.random() < p_delete:
            u, v = g.edges[int(rng.integers(g.m))]
            out.append(EdgeEvent("-", int(u), int(v)))
        else:
            out.append(EdgeEvent(
                "+", int(rng.integers(g.n_u)), int(rng.integers(g.n_v))))
    return out
