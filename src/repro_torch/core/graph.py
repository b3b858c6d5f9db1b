"""Bipartite graph container used by every PBNG engine (pure numpy).

A copy of the JAX package's ``core/graph.py``: the generators draw from
the same ``np.random.default_rng(seed)`` streams, so both packages build
the same edge list from the same seed (held array-equal by
``tests/test_torch_scaffold.py``).  Graphs are immutable edge lists plus
CSR offsets built on the host; the engines express deletion with
``alive`` masks on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "from_tsv",
    "BipartiteGraph",
    "random_bipartite",
    "powerlaw_bipartite",
    "paper_proxy_dataset",
    "PAPER_PROXIES",
]


@dataclasses.dataclass(frozen=True)
class BipartiteGraph:
    """Static bipartite graph ``G(U, V, E)``.

    Attributes
    ----------
    n_u, n_v : sizes of the two vertex sets.
    edges    : (m, 2) int32 array of (u, v) pairs, deduplicated,
               sorted lexicographically.  ``edges[:, 0] in [0, n_u)``,
               ``edges[:, 1] in [0, n_v)``.
    """

    n_u: int
    n_v: int
    edges: np.ndarray  # (m, 2) int32

    # ---------------------------------------------------------------- basic
    @property
    def m(self) -> int:
        """Edge count |E|."""
        return int(self.edges.shape[0])

    @property
    def n(self) -> int:
        """Combined vertex count |U| + |V|."""
        return self.n_u + self.n_v

    def degrees(self) -> Tuple[np.ndarray, np.ndarray]:
        """(d_u, d_v) int64 degree vectors."""
        du = np.bincount(self.edges[:, 0], minlength=self.n_u)
        dv = np.bincount(self.edges[:, 1], minlength=self.n_v)
        return du.astype(np.int64), dv.astype(np.int64)

    # ----------------------------------------------------------------- CSR
    def csr_u(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-U CSR: (offsets[n_u+1], neighbor v ids, edge ids)."""
        order = np.lexsort((self.edges[:, 1], self.edges[:, 0]))
        e = self.edges[order]
        du, _ = self.degrees()
        off = np.zeros(self.n_u + 1, dtype=np.int64)
        np.cumsum(du, out=off[1:])
        return off, e[:, 1].astype(np.int32), order.astype(np.int32)

    def csr_v(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-V CSR: (offsets[n_v+1], neighbor u ids, edge ids)."""
        order = np.lexsort((self.edges[:, 0], self.edges[:, 1]))
        e = self.edges[order]
        _, dv = self.degrees()
        off = np.zeros(self.n_v + 1, dtype=np.int64)
        np.cumsum(dv, out=off[1:])
        return off, e[:, 0].astype(np.int32), order.astype(np.int32)

    # --------------------------------------------------------------- dense
    def adjacency(self, dtype=np.float32) -> np.ndarray:
        """Dense (n_u, n_v) adjacency — the MXU-friendly representation."""
        A = np.zeros((self.n_u, self.n_v), dtype=dtype)
        A[self.edges[:, 0], self.edges[:, 1]] = 1
        return A

    def transpose(self) -> "BipartiteGraph":
        """Swap U and V (tip decomposition of the V side peels the
        transpose's U side)."""
        e = self.edges[:, ::-1].copy()
        order = np.lexsort((e[:, 1], e[:, 0]))
        return BipartiteGraph(self.n_v, self.n_u, e[order])

    # --------------------------------------------------------------- build
    @staticmethod
    def from_edges(n_u: int, n_v: int, edges) -> "BipartiteGraph":
        """Canonical constructor: dedup + lexsort + bounds-check edges."""
        e = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
        if e.size:
            e = np.unique(e, axis=0)
            assert e[:, 0].min() >= 0 and e[:, 0].max() < n_u, "u id out of range"
            assert e[:, 1].min() >= 0 and e[:, 1].max() < n_v, "v id out of range"
        return BipartiteGraph(int(n_u), int(n_v), e)


# -------------------------------------------------------------- generators
def random_bipartite(
    n_u: int, n_v: int, m: int, seed: int = 0
) -> BipartiteGraph:
    """Erdos–Renyi-style bipartite graph with ~m distinct edges."""
    rng = np.random.default_rng(seed)
    m = min(m, n_u * n_v)
    u = rng.integers(0, n_u, size=2 * m + 8)
    v = rng.integers(0, n_v, size=2 * m + 8)
    e = np.unique(np.stack([u, v], axis=1), axis=0)
    if e.shape[0] > m:
        sel = rng.choice(e.shape[0], size=m, replace=False)
        e = e[np.sort(sel)]
    return BipartiteGraph.from_edges(n_u, n_v, e)


def powerlaw_bipartite(
    n_u: int, n_v: int, m: int, alpha: float = 1.3, seed: int = 0
) -> BipartiteGraph:
    """Skewed-degree bipartite graph (preferential attachment flavour).

    Real datasets in the paper (trackers, orkut, wikipedia) are heavily
    skewed; butterfly counts explode super-linearly with skew, which is
    the regime PBNG targets.
    """
    rng = np.random.default_rng(seed)
    pu = (np.arange(1, n_u + 1, dtype=np.float64)) ** (-alpha)
    pv = (np.arange(1, n_v + 1, dtype=np.float64)) ** (-alpha)
    pu /= pu.sum()
    pv /= pv.sum()
    u = rng.choice(n_u, size=3 * m, p=pu)
    v = rng.choice(n_v, size=3 * m, p=pv)
    e = np.unique(np.stack([u, v], axis=1), axis=0)
    if e.shape[0] > m:
        sel = rng.choice(e.shape[0], size=m, replace=False)
        e = e[np.sort(sel)]
    return BipartiteGraph.from_edges(n_u, n_v, e)


# Laptop-scale stand-ins for the paper's table-2 datasets.  Name -> kwargs.
PAPER_PROXIES = {
    # name          n_u    n_v     m      alpha  seed
    "di_af":   dict(n_u=700, n_v=120, m=2200, alpha=1.10, seed=1),
    "de_ti":   dict(n_u=900, n_v=160, m=3200, alpha=1.20, seed=2),
    "fr":      dict(n_u=260, n_v=380, m=2600, alpha=1.25, seed=3),
    "di_st":   dict(n_u=800, n_v=48,  m=2800, alpha=1.05, seed=4),
    "it":      dict(n_u=900, n_v=220, m=3600, alpha=1.30, seed=5),
    "digg":    dict(n_u=600, n_v=64,  m=4200, alpha=1.15, seed=6),
    "en":      dict(n_u=1400, n_v=420, m=5200, alpha=1.30, seed=7),
    "lj":      dict(n_u=1100, n_v=900, m=5600, alpha=1.35, seed=8),
    "gtr":     dict(n_u=520, n_v=760, m=6400, alpha=1.20, seed=9),
    "tr":      dict(n_u=1600, n_v=900, m=7000, alpha=1.45, seed=10),
    "or_":     dict(n_u=900, n_v=1600, m=8000, alpha=1.30, seed=11),
    "de_ut":   dict(n_u=1000, n_v=420, m=6000, alpha=1.25, seed=12),
}


def paper_proxy_dataset(name: str) -> BipartiteGraph:
    """Scaled-down synthetic proxy for a paper dataset (same skew regime)."""
    kw = PAPER_PROXIES[name]
    return powerlaw_bipartite(**kw)


def from_tsv(path: str, comment: str = "%") -> BipartiteGraph:
    """Load a KONECT-style bipartite edge list (u<TAB>v per line, 1-based
    or 0-based ids; comment lines start with '%').  Ids are compacted."""
    us, vs = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(comment):
                continue
            parts = line.split()
            us.append(int(parts[0]))
            vs.append(int(parts[1]))
    u = np.asarray(us, dtype=np.int64)
    v = np.asarray(vs, dtype=np.int64)
    _, u = np.unique(u, return_inverse=True)
    _, v = np.unique(v, return_inverse=True)
    return BipartiteGraph.from_edges(
        int(u.max()) + 1 if u.size else 0,
        int(v.max()) + 1 if v.size else 0,
        np.stack([u, v], axis=1),
    )
