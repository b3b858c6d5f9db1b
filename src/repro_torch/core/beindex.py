"""Bloom-Edge-Index (BE-Index, §2.3) — paper-faithful butterfly index.

A *maximal priority bloom* is a (2,k)-biclique whose dominant 2-vertex set
contains the bloom's highest-priority vertex (priority = decreasing degree
over the combined vertex set, ties by id).  Every butterfly lives in
exactly one bloom (property 2); an edge shares k−1 butterflies with its
twin and 1 with every other bloom edge (property 1).

Construction happens on the host in numpy (a data-pipeline step);
peeling consumes the flat arrays on the device through int32
``index_add_`` (``core.peel._wing_update``), the replacement for the
paper's atomics.  The port of the JAX package's ``core/beindex.py``:
the same enumeration order, so every array is equal to the reference's.

Flat layout (all int32):
    bloom_k[nb]       initial bloom number (alive twin pairs)
    link_edge[L]      link -> edge id          (grouped by bloom)
    link_twin[L]      link -> twin edge id
    link_bloom[L]     link -> bloom id
Each twin *pair* contributes two links (e, t) and (t, e).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np

from .graph import BipartiteGraph

__all__ = ["BEIndex", "build_beindex"]


@dataclasses.dataclass(frozen=True)
class BEIndex:
    """Flat Bloom-Edge-Index (§2.3): every (edge, twin) pair of every
    maximal priority bloom as parallel link arrays."""

    nb: int
    bloom_k: np.ndarray     # (nb,) int32 — #twin pairs per bloom
    link_edge: np.ndarray   # (L,) int32
    link_twin: np.ndarray   # (L,) int32
    link_bloom: np.ndarray  # (L,) int32

    @property
    def n_links(self) -> int:
        """Number of (edge, twin, bloom) links in the index."""
        return int(self.link_edge.shape[0])

    def total_butterflies(self) -> int:
        """⋈(G) = Σ_B C(k_B, 2) — every butterfly sits in one bloom."""
        k = self.bloom_k.astype(np.int64)
        return int((k * (k - 1) // 2).sum())

    def edge_support(self, m: int) -> np.ndarray:
        """⋈_e = Σ_{B∋e} (k_B − 1) — support init straight from the index."""
        out = np.zeros(m, dtype=np.int64)
        np.add.at(out, self.link_edge,
                  self.bloom_k[self.link_bloom].astype(np.int64) - 1)
        return out


def _priority_labels(g: BipartiteGraph) -> np.ndarray:
    """Combined-vertex labels: 0 = highest degree (highest priority)."""
    du, dv = g.degrees()
    deg = np.concatenate([du, dv])
    order = np.lexsort((np.arange(deg.size), -deg))
    labels = np.empty(deg.size, dtype=np.int64)
    labels[order] = np.arange(deg.size)
    return labels


def build_beindex(g: BipartiteGraph) -> BEIndex:
    """Enumerate maximal priority blooms from both vertex sides.

    For a same-side pair {a, b} with higher-priority member h, the bloom's
    non-dominant set is every common neighbour ``mid`` with
    label(mid) > label(h).  Blooms with k < 2 hold no butterflies and are
    dropped.  Cost: Σ_mid d_mid² wedge enumerations (host Python).
    """
    labels = _priority_labels(g).tolist()
    eid: Dict[Tuple[int, int], int] = {
        (int(u), int(v)): i for i, (u, v) in enumerate(g.edges.tolist())
    }
    # adjacency lists over combined ids: U vertex u -> u; V vertex v -> n_u+v
    nbrs = [[] for _ in range(g.n + 1)]
    for u, v in g.edges.tolist():
        nbrs[u].append(g.n_u + v)
        nbrs[g.n_u + v].append(u)

    # blooms[(a, b)] = list of mids (a < b combined ids, same side),
    # in first-seen order (dict insertion order fixes the bloom ids)
    blooms: Dict[Tuple[int, int], list] = defaultdict(list)
    for mid in range(g.n):
        ns = nbrs[mid]
        lm = labels[mid]
        for i in range(len(ns)):
            a0 = ns[i]
            la = labels[a0]
            for j in range(i + 1, len(ns)):
                a, b = a0, ns[j]
                # higher-priority endpoint = smaller label
                if lm > min(la, labels[b]):
                    if a > b:
                        a, b = b, a
                    blooms[(a, b)].append(mid)

    bloom_k, link_edge, link_twin, link_bloom = [], [], [], []
    nb = 0

    def edge_of(x: int, y: int) -> int:
        # one of x, y is a U id, the other a combined V id
        if x < g.n_u:
            return eid[(x, y - g.n_u)]
        return eid[(y, x - g.n_u)]

    for (a, b), mids in blooms.items():
        k = len(mids)
        if k < 2:
            continue
        bid = nb
        nb += 1
        bloom_k.append(k)
        for mid in mids:
            e1 = edge_of(a, mid)
            e2 = edge_of(b, mid)
            link_edge.extend((e1, e2))
            link_twin.extend((e2, e1))
            link_bloom.extend((bid, bid))

    return BEIndex(
        nb=nb,
        bloom_k=np.asarray(bloom_k, dtype=np.int32).reshape(-1),
        link_edge=np.asarray(link_edge, dtype=np.int32).reshape(-1),
        link_twin=np.asarray(link_twin, dtype=np.int32).reshape(-1),
        link_bloom=np.asarray(link_bloom, dtype=np.int32).reshape(-1),
    )
