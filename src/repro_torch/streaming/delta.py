"""Wedge-local support deltas + dirty-partition detection — a copy of
the JAX package's ``streaming/delta.py`` (host Python and numpy) on the
port's own ``core/graph.py``, held equal to the original by
``tests/test_torch_streaming.py``.

A changed edge (u, v) only perturbs butterflies through its wedges:
every butterfly it enters or leaves is {u, u2} x {v, v2} with
u2 ∈ N(v) and v2 ∈ N(u) ∩ N(u2) — so one micro-epoch's exact support
delta is a host-side walk over the event endpoints' neighborhoods,
never a global recount.  :func:`support_delta` performs that walk
sequentially over the coalesced events (deletes first, then inserts,
each against the adjacency state the previous event left behind) and
returns both the per-entity delta and the **touched** set: every
entity whose incident wedge/pair structure changed, which is exactly
the set whose FD behaviour could differ.

:func:`dirty_partitions` turns the touched set plus the fresh Phase-1
output into the set of CD partitions whose FD must re-run.  The rule is
a sound prefix bound: partition j's FD reads the entire ≥j induced
subgraph (``_wing_fd_csr`` folds all ≥j wedges into its pair-count
init; the dense FD re-counts on the ≥j adjacency), so j can reuse the
previous epoch's θ iff **no** affected entity — inserted, deleted,
moved across partitions, ⋈init-changed, or touched — lies in a
partition ≥ j on either side.  Dirty = {0..Jmax} with Jmax the highest
affected partition; everything above Jmax sees a bit-identical input
by entity key and is carried over.  The differential harness
(``tests/test_torch_streaming.py``) machine-checks this soundness
argument after every epoch.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Set, Tuple

import numpy as np

from ..core.graph import BipartiteGraph

__all__ = [
    "edge_codes",
    "support_delta",
    "wing_sup0_new",
    "common_entities",
    "dirty_partitions",
]


def edge_codes(g: BipartiteGraph) -> np.ndarray:
    """Stable edge keys ``u * n_v + v`` — ascending, because edges are
    lexicographically sorted; the old→new id map over common keys is
    therefore monotone (what keeps min-id component labels mappable)."""
    return g.edges[:, 0].astype(np.int64) * g.n_v + g.edges[:, 1]


def support_delta(
    gg_old: BipartiteGraph,
    inserts: np.ndarray,
    deletes: np.ndarray,
    kind: str,
) -> Tuple[Dict, Set]:
    """Exact butterfly-support delta of one coalesced micro-epoch.

    Returns ``(delta, touched)``: for ``kind="wing"`` keyed by edge
    ``(u, v)`` tuples, for ``kind="tip"`` keyed by U-side vertex ids —
    both in the *internal* (gg) orientation.  ``delta`` sums each
    entity's butterfly-count change; for inserted edges it holds the
    full new-edge count.  ``touched`` contains every entity whose
    incident wedge or pair structure changed — a superset of the keys
    with nonzero delta (a wedge can appear without completing any
    butterfly, yet still change FD's wedge lists and update counts)."""
    if kind not in ("wing", "tip"):
        raise ValueError(kind)
    adj_u: Dict[int, set] = defaultdict(set)
    adj_v: Dict[int, set] = defaultdict(set)
    for u, v in gg_old.edges:
        adj_u[int(u)].add(int(v))
        adj_v[int(v)].add(int(u))
    delta: Dict = defaultdict(int)
    touched: Set = set()

    def one(u: int, v: int, sign: int) -> None:
        # adjacency state EXCLUDES (u, v): counts the butterflies the
        # edge closes with the rest of the current graph
        if kind == "wing":
            touched.add((u, v))
            cnt = 0
            for u2 in adj_v[v]:
                touched.add((u2, v))
                commons = adj_u[u] & adj_u[u2]
                commons.discard(v)
                c = len(commons)
                if c:
                    delta[(u2, v)] += sign * c
                    cnt += c
                    for v2 in commons:
                        delta[(u, v2)] += sign
                        delta[(u2, v2)] += sign
                        touched.add((u, v2))
                        touched.add((u2, v2))
            delta[(u, v)] += sign * cnt
        else:
            touched.add(u)
            for u2 in adj_v[v]:
                touched.add(u2)
                commons = adj_u[u] & adj_u[u2]
                commons.discard(v)
                c = len(commons)
                if c:
                    delta[u] += sign * c
                    delta[u2] += sign * c

    for u, v in deletes.tolist():
        adj_u[u].discard(v)
        adj_v[v].discard(u)
        one(u, v, -1)
    for u, v in inserts.tolist():
        one(u, v, +1)
        adj_u[u].add(v)
        adj_v[v].add(u)
    return dict(delta), touched


def wing_sup0_new(
    gg_old: BipartiteGraph,
    sup0_old: np.ndarray,
    gg_new: BipartiteGraph,
    delta: Dict,
) -> np.ndarray:
    """⋈init for the new edge set: carried counts + delta, by edge key."""
    sup_new = np.zeros(gg_new.m, dtype=np.int64)
    codes_old = edge_codes(gg_old)
    codes_new = edge_codes(gg_new)
    if codes_old.size and codes_new.size:
        pos = np.searchsorted(codes_old, codes_new)
        pos_c = np.minimum(pos, codes_old.size - 1)
        has = codes_old[pos_c] == codes_new
        sup_new[has] = sup0_old[pos_c[has]]
    if delta:
        keys = np.asarray(
            [u * gg_new.n_v + v for (u, v) in delta], dtype=np.int64)
        vals = np.asarray(list(delta.values()), dtype=np.int64)
        pos = np.searchsorted(codes_new, keys)
        pos_c = np.minimum(pos, max(codes_new.size - 1, 0))
        has = (codes_new.size > 0) & (codes_new[pos_c] == keys)
        np.add.at(sup_new, pos_c[has], vals[has])
    return sup_new


def common_entities(
    gg_old: BipartiteGraph, gg_new: BipartiteGraph, kind: str
) -> Tuple[np.ndarray, np.ndarray]:
    """Aligned index arrays ``(old_idx, new_idx)`` of the entities
    present in both graphs (edges matched by key for wing; U-side
    vertices are the identity for tip).  Both ascending, so the induced
    old→new id map is monotone."""
    if kind == "tip":
        ids = np.arange(gg_old.n_u, dtype=np.int64)
        return ids, ids.copy()
    codes_old = edge_codes(gg_old)
    codes_new = edge_codes(gg_new)
    _, old_idx, new_idx = np.intersect1d(
        codes_old, codes_new, assume_unique=True, return_indices=True)
    return old_idx.astype(np.int64), new_idx.astype(np.int64)


def dirty_partitions(
    part_old: np.ndarray,
    part_new: np.ndarray,
    old_common: np.ndarray,
    new_common: np.ndarray,
    sup_init_old: np.ndarray,
    sup_init_new: np.ndarray,
    touched_old: np.ndarray,
    touched_new: np.ndarray,
    p_eff_old: int,
    p_eff_new: int,
) -> np.ndarray:
    """Partition ids of the new CD run whose FD must re-run.

    An entity is *affected* when it exists on only one side (insert /
    delete), moved partitions, changed ⋈init, or is structurally
    touched.  Every partition up to the highest affected one is dirty
    (the prefix bound — see the module docstring); partitions the old
    run never produced are dirty unconditionally."""
    jmax = -1
    old_only = np.ones(part_old.size, dtype=bool)
    old_only[old_common] = False
    new_only = np.ones(part_new.size, dtype=bool)
    new_only[new_common] = False
    changed = (
        (part_old[old_common] != part_new[new_common])
        | (sup_init_old[old_common] != sup_init_new[new_common])
    )
    for arr in (
        part_old[old_only | touched_old],
        part_new[new_only | touched_new],
        part_old[old_common][changed],
        part_new[new_common][changed],
    ):
        if arr.size:
            jmax = max(jmax, int(arr.max()))
    dirty = np.arange(min(jmax + 1, p_eff_new), dtype=np.int64)
    if p_eff_new > p_eff_old:
        dirty = np.union1d(
            dirty, np.arange(p_eff_old, p_eff_new, dtype=np.int64))
    return dirty
