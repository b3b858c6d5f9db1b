"""Pure-python / numpy oracles for every PBNG quantity.

A copy of the JAX package's ``core/ref.py`` (numpy only) on the port's
own ``core/graph.py``, held array-equal to the original by
``tests/test_torch_analysis.py``, so a machine without JAX has the BUP
and hierarchy oracles too.  Written for clarity, not speed — use on
graphs up to a few thousand edges.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .graph import BipartiteGraph

__all__ = [
    "butterfly_count_total",
    "vertex_butterflies_ref",
    "edge_butterflies_ref",
    "bup_tip_ref",
    "bup_wing_ref",
    "wedge_count_ref",
    "wing_components_ref",
    "tip_components_ref",
    "wing_hierarchy_ref",
    "tip_hierarchy_ref",
]


def _neighbor_sets(g: BipartiteGraph) -> Tuple[List[set], List[set]]:
    nu: List[set] = [set() for _ in range(g.n_u)]
    nv: List[set] = [set() for _ in range(g.n_v)]
    for u, v in g.edges:
        nu[u].add(int(v))
        nv[v].add(int(u))
    return nu, nv


def _common_matrix(g: BipartiteGraph) -> np.ndarray:
    """W[u, u'] = |N_u ∩ N_u'| (wedge counts between U-pairs)."""
    A = g.adjacency(dtype=np.int64)
    return A @ A.T


def butterfly_count_total(g: BipartiteGraph) -> int:
    """⋈(G) ground truth: Σ over U pairs of C(#common neighbours, 2)."""
    W = _common_matrix(g)
    np.fill_diagonal(W, 0)
    return int((W * (W - 1) // 2).sum() // 2)


def vertex_butterflies_ref(g: BipartiteGraph) -> Tuple[np.ndarray, np.ndarray]:
    """Per-vertex butterfly counts (⋈_u for U, ⋈_v for V)."""
    W = _common_matrix(g)
    np.fill_diagonal(W, 0)
    bu = (W * (W - 1) // 2).sum(axis=1)
    Wt = _common_matrix(g.transpose())
    np.fill_diagonal(Wt, 0)
    bv = (Wt * (Wt - 1) // 2).sum(axis=1)
    return bu.astype(np.int64), bv.astype(np.int64)


def edge_butterflies_ref(g: BipartiteGraph) -> np.ndarray:
    """⋈_e for every edge: Σ_{u'∈N_v \\ u} (|N_u ∩ N_u'| − 1)."""
    nu, nv = _neighbor_sets(g)
    out = np.zeros(g.m, dtype=np.int64)
    for i, (u, v) in enumerate(g.edges):
        s = 0
        for up in nv[v]:
            if up == u:
                continue
            s += len(nu[u] & nu[up]) - 1
        out[i] = s
    return out


def wedge_count_ref(g: BipartiteGraph) -> Tuple[np.ndarray, np.ndarray]:
    """Per-vertex wedge endpoints workload: Σ_{v∈N_u} d_v (paper's tip proxy)."""
    du, dv = g.degrees()
    wu = np.zeros(g.n_u, dtype=np.int64)
    wv = np.zeros(g.n_v, dtype=np.int64)
    for u, v in g.edges:
        wu[u] += dv[v]
        wv[v] += du[u]
    return wu, wv


# ------------------------------------------------------------------ peeling
def bup_tip_ref(g: BipartiteGraph, side: str = "u") -> np.ndarray:
    """Sequential bottom-up tip decomposition (alg.2 specialised to vertices).

    Returns tip numbers for the peeled side.  Exploits that V is never
    removed, so pairwise butterfly counts C(W[u,u'], 2) are static.
    """
    gg = g if side == "u" else g.transpose()
    n = gg.n_u
    W = _common_matrix(gg)
    np.fill_diagonal(W, 0)
    pair_bf = W * (W - 1) // 2  # butterflies shared by each U-pair
    support = pair_bf.sum(axis=1)
    alive = np.ones(n, dtype=bool)
    theta = np.zeros(n, dtype=np.int64)
    k = 0
    for _ in range(n):
        idx = np.where(alive)[0]
        if idx.size == 0:
            break
        u = idx[np.argmin(support[idx])]
        k = max(k, int(support[u]))
        theta[u] = k
        alive[u] = False
        support[alive] -= pair_bf[u, alive]
    return theta


def bup_wing_ref(g: BipartiteGraph) -> np.ndarray:
    """Sequential bottom-up wing (bitruss) decomposition — alg.2.

    Recomputes supports incrementally via explicit butterfly enumeration
    per peeled edge.  O(m · ⋈) — oracle-grade only.
    """
    m = g.m
    nu, nv = _neighbor_sets(g)
    eid: Dict[Tuple[int, int], int] = {
        (int(u), int(v)): i for i, (u, v) in enumerate(g.edges)
    }
    support = edge_butterflies_ref(g).copy()
    alive = np.ones(m, dtype=bool)
    theta = np.zeros(m, dtype=np.int64)
    k = 0
    for _ in range(m):
        idx = np.where(alive)[0]
        if idx.size == 0:
            break
        e = idx[np.argmin(support[idx])]
        k = max(k, int(support[e]))
        theta[e] = k
        alive[e] = False
        u, v = (int(x) for x in g.edges[e])
        nu[u].discard(v)
        nv[v].discard(u)
        # Every butterfly through e: pick v' ∈ N_u \ v, u' ∈ N_v ∩ N_v' \ u.
        for vp in list(nu[u]):
            e1 = eid[(u, vp)]
            for up in nv[v]:
                if up == u or vp not in nu[up]:
                    continue
                e2 = eid[(up, v)]
                e3 = eid[(up, vp)]
                for other in (e1, e2, e3):
                    if alive[other]:
                        support[other] = max(k, support[other] - 1)
    return theta


# ------------------------------------------------------ hierarchy oracle
class _UnionFind:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, x: int) -> int:
        """Root of x's set, with path halving."""
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a: int, b: int) -> None:
        """Merge the sets of a and b (min root wins, for determinism)."""
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[max(ra, rb)] = min(ra, rb)


def wing_components_ref(g: BipartiteGraph, alive_e: np.ndarray) -> List[frozenset]:
    """Butterfly-connected components of an edge-induced subgraph.

    Brute force from neighbor sets: for every U pair (u1, u2), the
    common V neighbors reached through *alive* edges; any two of them
    form a butterfly on the pair, so all of the pair's alive edges merge
    into one group whenever ≥ 2 common neighbors exist.  Components are
    the transitive closure (union-find); edges in no butterfly stay out.
    """
    eid: Dict[Tuple[int, int], int] = {
        (int(u), int(v)): i for i, (u, v) in enumerate(g.edges)
    }
    adj: List[set] = [set() for _ in range(g.n_u)]
    for i, (u, v) in enumerate(g.edges):
        if alive_e[i]:
            adj[int(u)].add(int(v))
    uf = _UnionFind(g.m)
    in_bf = np.zeros(g.m, dtype=bool)
    for u1 in range(g.n_u):
        for u2 in range(u1 + 1, g.n_u):
            common = adj[u1] & adj[u2]
            if len(common) < 2:
                continue
            es = [eid[(u1, v)] for v in common] + [eid[(u2, v)] for v in common]
            in_bf[es] = True
            for e in es[1:]:
                uf.union(es[0], e)
    comps: Dict[int, set] = {}
    for e in range(g.m):
        if in_bf[e]:
            comps.setdefault(uf.find(e), set()).add(e)
    return [frozenset(c) for c in comps.values()]


def tip_components_ref(g: BipartiteGraph, alive_u: np.ndarray) -> List[frozenset]:
    """Butterfly-connected components of a vertex-induced subgraph
    (peeled side = U; transpose first for the V side).  Two U vertices
    join when they share ≥ 2 common neighbors — i.e. a butterfly."""
    adj: List[set] = [set() for _ in range(g.n_u)]
    for u, v in g.edges:
        if alive_u[int(u)]:
            adj[int(u)].add(int(v))
    uf = _UnionFind(g.n_u)
    in_bf = np.zeros(g.n_u, dtype=bool)
    for u1 in range(g.n_u):
        for u2 in range(u1 + 1, g.n_u):
            if len(adj[u1] & adj[u2]) >= 2:
                in_bf[u1] = in_bf[u2] = True
                uf.union(u1, u2)
    comps: Dict[int, set] = {}
    for u in range(g.n_u):
        if in_bf[u]:
            comps.setdefault(uf.find(u), set()).add(u)
    return [frozenset(c) for c in comps.values()]


def wing_hierarchy_ref(
    g: BipartiteGraph, theta: np.ndarray
) -> Dict[int, set]:
    """Ground-truth k-wing hierarchy: for every distinct level k ≥ 1,
    the butterfly-connected components of the θ ≥ k edge subgraph, as a
    set of frozensets of edge ids."""
    out: Dict[int, set] = {}
    for k in np.unique(theta[theta > 0]):
        out[int(k)] = set(wing_components_ref(g, theta >= k))
    return out


def tip_hierarchy_ref(
    g: BipartiteGraph, theta: np.ndarray, side: str = "u"
) -> Dict[int, set]:
    """Ground-truth k-tip hierarchy of the peeled side (vertex ids)."""
    gg = g if side == "u" else g.transpose()
    out: Dict[int, set] = {}
    for k in np.unique(theta[theta > 0]):
        out[int(k)] = set(tip_components_ref(gg, theta >= k))
    return out
