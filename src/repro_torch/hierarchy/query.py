"""O(1) / O(log) queries against the packed hierarchy forest.

:class:`PackedForest` is the device view of a
:class:`~repro_torch.hierarchy.build.Hierarchy`: flat int32 tensors
(preorder stamps, entity→node, binary-lifting table) that every query
reads with gathers — no tree walking, no host round-trips inside a
batch.

* containment — an entity's subtree test is one interval check on
  preorder stamps (``tin``/``tout``), so ``subgraph_at`` is a
  vectorized compare over all entities.
* ancestors / LCA — binary lifting over ``up[:, j]`` = the 2^j-th
  ancestor, O(log depth) per query, elementwise ``torch.where`` steps.

Batched entry points take arrays (numpy, lists or tensors) and return
tensors on the forest's device.  Unlike JAX's gathers, an out-of-range
index faults on a CUDA tensor instead of clamping; the service checks
ids on the host before it dispatches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..device import resolve_device
from .build import Hierarchy

__all__ = [
    "PackedForest",
    "depth_and_up",
    "extend_up",
    "pack_forest",
    "max_k_containing",
    "node_of",
    "subgraph_at",
    "lca_nodes",
    "lca_entities",
    "density_profile",
    "top_densest_leaves",
]


@dataclasses.dataclass(frozen=True)
class PackedForest:
    """Device tensors of one hierarchy (see :func:`pack_forest`)."""

    n_nodes: int
    n_entities: int
    J: int                       # binary-lifting levels
    theta: torch.Tensor          # (n_entities,) int32
    entity_node: torch.Tensor    # (n_entities,) int32
    ent_tin: torch.Tensor        # (n_entities,) int32 — tin of entity's node
    node_level: torch.Tensor     # (n_nodes,) int32
    depth: torch.Tensor          # (n_nodes,) int32
    tin: torch.Tensor            # (n_nodes,) int32
    tout: torch.Tensor           # (n_nodes,) int32
    node_size: torch.Tensor      # (n_nodes,) int32 — subtree entity count
    up: torch.Tensor             # (n_nodes, J) int32 — 2^j-th ancestors

    @property
    def device(self) -> torch.device:
        """The device every tensor of the forest lies on."""
        return self.theta.device


def depth_and_up(parent: np.ndarray, J: int = 0):
    """Host-side depth vector + binary-lifting table from ``parent``.

    ``up[:, j]`` is the ``2^j``-th ancestor (the root lifts to itself).
    ``J`` widens the table to at least that many levels (extra levels
    are identity columns past the root).  Returns ``(depth, up)``.
    """
    n = int(parent.shape[0])
    depth = np.zeros(n, dtype=np.int32)
    for x in range(1, n):                      # parent[x] < x always
        depth[x] = depth[parent[x]] + 1
    max_depth = int(depth.max()) if n else 0
    J = max(1, J, int(np.ceil(np.log2(max_depth + 1))) if max_depth else 1)
    up = np.zeros((n, J), dtype=np.int32)
    up[:, 0] = np.maximum(parent, 0)           # root lifts to itself
    for j in range(1, J):
        up[:, j] = up[up[:, j - 1], j - 1]
    return depth, up


def extend_up(up: np.ndarray, J: int) -> np.ndarray:
    """Widen a lifting table to ``J`` levels by repeated squaring."""
    cols = [up[:, j] for j in range(up.shape[1])]
    while len(cols) < J:
        prev = cols[-1]
        cols.append(prev[prev])
    return np.stack(cols[:max(J, 1)], axis=1).astype(np.int32)


def pack_forest(h: Hierarchy, device="cuda") -> PackedForest:
    """Host → device packing; also materializes depth + lifting table
    (reused from the artifact's pack cache when a v2 file carried
    one)."""
    dev = resolve_device(device)
    n = h.n_nodes
    depth = np.asarray(h.meta.get("pack_depth", ()), dtype=np.int32)
    up = np.asarray(h.meta.get("pack_up", ()), dtype=np.int32)
    if depth.shape != (n,) or up.ndim != 2 or up.shape[0] != n:
        depth, up = depth_and_up(h.parent)
    J = up.shape[1]
    # entity-less hierarchies still pack (node-arg queries remain
    # valid): one root-pointing sentinel slot keeps the entity gathers
    # well-formed; entity queries are rejected host-side before dispatch
    theta = h.theta if h.n_entities else np.zeros(1, np.int64)
    ent_node = h.entity_node if h.n_entities else np.zeros(1, np.int32)

    def t(x):
        return torch.from_numpy(
            np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    return PackedForest(
        n_nodes=n,
        n_entities=h.n_entities,
        J=J,
        theta=t(theta),
        entity_node=t(ent_node),
        ent_tin=t(h.tin[h.entity_node]),
        node_level=t(h.node_level),
        depth=t(depth),
        tin=t(h.tin),
        tout=t(h.tout),
        node_size=t(h.eend - h.estart),
        up=t(up),
    )


def _ids(f: PackedForest, x) -> torch.Tensor:
    """Index tensor on the forest's device (int64, at least 1-d)."""
    return torch.atleast_1d(
        torch.as_tensor(x, device=f.device).to(torch.int64))


# =====================================================================
# Point lookups — O(1) gathers
# =====================================================================
def max_k_containing(f: PackedForest, ids) -> torch.Tensor:
    """Largest k whose k-subgraph still contains each entity — its θ."""
    return f.theta[_ids(f, ids)]


def node_of(f: PackedForest, ids) -> torch.Tensor:
    """Deepest hierarchy node containing each entity."""
    return f.entity_node[_ids(f, ids)]


def subgraph_at(f: PackedForest, nodes) -> torch.Tensor:
    """(len(nodes), n_entities) bool — entity mask of each node's
    subgraph (edges for wing, one-side vertices for tip).  One interval
    compare per entity; no tree traversal."""
    nodes = _ids(f, nodes)
    lo = f.tin[nodes][:, None]
    hi = f.tout[nodes][:, None]
    return (f.ent_tin[None, :] >= lo) & (f.ent_tin[None, :] < hi)


# =====================================================================
# LCA — binary lifting, elementwise (batch = tensor in, tensor out)
# =====================================================================
def _lca(up, depth, x, y, J: int):
    x = x.to(torch.int64)
    y = y.to(torch.int64)
    dx = depth[x]
    dy = depth[y]
    swap = dy > dx
    a = torch.where(swap, y, x)
    b = torch.where(swap, x, y)
    diff = depth[a] - depth[b]
    for j in range(J):                     # lift a to b's depth
        a = torch.where((diff >> j) & 1 > 0, up[a, j].to(torch.int64), a)
    eq = a == b
    for j in range(J - 1, -1, -1):         # descend to just below LCA
        ua = up[a, j].to(torch.int64)
        ub = up[b, j].to(torch.int64)
        ne = (ua != ub) & ~eq
        a = torch.where(ne, ua, a)
        b = torch.where(ne, ub, b)
    return torch.where(eq, a, up[a, 0].to(torch.int64)).to(torch.int32)


def lca_nodes(f: PackedForest, x, y) -> torch.Tensor:
    """Lowest common ancestor node(s) — the smallest dense subgraph in
    the hierarchy containing both."""
    return _lca(f.up, f.depth, _ids(f, x), _ids(f, y), f.J)


def lca_entities(f: PackedForest, e1, e2) -> torch.Tensor:
    """Smallest common dense subgraph of two entities (node id); its
    level is ``f.node_level[lca_entities(...)]``."""
    return _lca(f.up, f.depth, f.entity_node[_ids(f, e1)],
                f.entity_node[_ids(f, e2)], f.J)


# =====================================================================
# Aggregates — host-side on the Hierarchy (one-shot analytics)
# =====================================================================
def density_profile(h: Hierarchy, k: int) -> Dict:
    """Components of the k-subgraph (θ ≥ k): the maximal nodes with
    level ≥ k.  Returns their ids, subtree entity counts, induced
    subgraph sizes, and edge densities m/(nu·nv)."""
    if k <= 0:
        sel = np.array([0])
    else:
        plev = np.where(h.parent >= 0, h.node_level[np.maximum(h.parent, 0)],
                        -1)
        sel = np.where((h.node_level >= k) & (plev < k))[0]
    return dict(
        k=int(k),
        nodes=sel,
        n_components=int(sel.size),
        sizes=(h.eend - h.estart)[sel],
        m=h.node_m[sel],
        nu=h.node_nu[sel],
        nv=h.node_nv[sel],
        density=h.density[sel],
    )


def top_densest_leaves(h: Hierarchy, t: int = 10) -> Dict:
    """The t densest leaves — the innermost (undominated) dense
    subgraphs, ranked by induced edge density."""
    leaf = np.diff(h.child_off) == 0
    ids = np.where(leaf)[0]
    order = np.argsort(-h.density[ids], kind="stable")[:t]
    sel = ids[order]
    return dict(
        nodes=sel,
        level=h.node_level[sel],
        density=h.density[sel],
        m=h.node_m[sel],
        nu=h.node_nu[sel],
        nv=h.node_nv[sel],
    )
