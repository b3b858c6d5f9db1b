"""θ → hierarchy forest: the nested dense-subgraph DAG (Sarıyüce's
k-wing / k-tip nuclei) materialized from peel output.

For every distinct level k ≥ 1 the k-subgraph is the set of entities
with θ ≥ k (edges for wing, one-side vertices for tip); its
*butterfly-connected* components are the hierarchy nodes.  Components
only split as k grows, so the nodes form a forest under containment,
rooted at a level-0 node holding the whole graph.

Connectivity is stated on the wedge machinery of ``core.csr``: two
entities are connected at level k iff a chain of butterflies of the
k-subgraph joins them, i.e. through the incidence entity ↔ pair
restricted to pairs holding ≥ 2 alive wedges.  Components are computed
on the device by min-label propagation over that incidence, a block of
``level_block`` levels at a time (one tensor state per block, so memory
stays O(level_block × wedges) however many levels the graph has); each
iteration is two ``scatter_reduce_(…, "amin")`` hops over the
level-offset incidence.  The host reads "did any label move" once per
:data:`LABEL_CHUNK` iterations, not once per iteration: extra hops at
the fixed point change nothing, because min is idempotent.

Nodes are *collapsed* (a node exists at level k only if some entity has
θ == k in it), each entity belongs to exactly one node, nodes are
created level-ascending (``parent[x] < x``) and member lists partition
the entity set.  The assembly from labels to the packed forest is a
numpy copy of the JAX package's, so the forest is bit-identical to it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from .. import obs
from ..core import csr
from ..core.graph import BipartiteGraph
from ..core.peel import resolve_device
from ..core.peelspec import PeelResult

__all__ = ["Hierarchy", "build_hierarchy"]

_BIG = torch.iinfo(torch.int32).max
# label-propagation iterations queued per host read of "any label moved"
LABEL_CHUNK = 8


# =====================================================================
# Packed forest container
# =====================================================================
@dataclasses.dataclass
class Hierarchy:
    """CSR-packed hierarchy forest (host numpy; see :mod:`query` for the
    device view).

    Node 0 is the level-0 root holding the whole graph; its *own*
    members are the butterfly-free entities (θ = 0).  ``ent_order``
    sorts entities by the preorder stamp of their node, so every node's
    subtree entity set is the contiguous slice
    ``ent_order[estart[x]:eend[x]]``.
    """

    kind: str                 # "wing" | "tip"
    n_entities: int
    theta: np.ndarray         # (n_entities,) int64 — peel numbers
    node_level: np.ndarray    # (n_nodes,) int64 — k of each node
    parent: np.ndarray        # (n_nodes,) int32 — parent id, -1 at root
    entity_node: np.ndarray   # (n_entities,) int32 — deepest node per entity
    member_off: np.ndarray    # (n_nodes+1,) int64 — own-member CSR
    member_ids: np.ndarray    # (n_entities,) int32
    child_off: np.ndarray     # (n_nodes+1,) int64 — children CSR
    child_ids: np.ndarray     # (n_nodes-1,) int32
    tin: np.ndarray           # (n_nodes,) int32 — preorder stamp
    tout: np.ndarray          # (n_nodes,) int32 — subtree = [tin, tout)
    ent_order: np.ndarray     # (n_entities,) int32 — entities by node tin
    estart: np.ndarray        # (n_nodes,) int64 — subtree slice start
    eend: np.ndarray          # (n_nodes,) int64 — subtree slice end
    node_m: np.ndarray        # (n_nodes,) int64 — induced edge count
    node_nu: np.ndarray       # (n_nodes,) int64 — induced |U| span
    node_nv: np.ndarray       # (n_nodes,) int64 — induced |V| span
    density: np.ndarray       # (n_nodes,) f64 — m / (nu · nv)
    meta: Dict                # provenance: engine tags, PeelStats, ...

    @property
    def n_nodes(self) -> int:
        """Number of forest nodes (dense subgraphs) after chain collapse."""
        return int(self.node_level.shape[0])

    @property
    def levels(self) -> np.ndarray:
        """Distinct θ levels ≥ 1 present in the forest, ascending."""
        lv = np.unique(self.node_level)
        return lv[lv > 0]

    def subtree_entities(self, node: int) -> np.ndarray:
        """All entities of the node's subgraph (own + descendants)."""
        return self.ent_order[int(self.estart[node]):int(self.eend[node])]

    def members(self, node: int) -> np.ndarray:
        """Own members only (entities with θ == node_level[node])."""
        return self.member_ids[
            int(self.member_off[node]):int(self.member_off[node + 1])
        ]

    def children(self, node: int) -> np.ndarray:
        """Child node ids (denser subgraphs nested inside this one)."""
        return self.child_ids[
            int(self.child_off[node]):int(self.child_off[node + 1])
        ]


# =====================================================================
# Batched connected components (device): min-label propagation
# =====================================================================
def _label_components(
    alive_inc: torch.Tensor,  # (L, n_inc) bool — incidence alive per level
    inc_e: torch.Tensor,      # (n_inc,) int64 — entity endpoint
    inc_g: torch.Tensor,      # (n_inc,) int64 — group (pair) endpoint
    lab0: torch.Tensor,       # (L, n_entities) int32 — entity id | _BIG dead
    n_entities: int,
    n_groups: int,
    counts: Optional[Dict] = None,
) -> torch.Tensor:
    """Connected components of L level-subgraphs at once.

    Each iteration is two min hops over the entity↔group incidence
    (entity labels → group minima → back), for every level in one
    scatter.  The fixed point labels every entity with the minimum
    entity id of its component (``_BIG`` for dead entities).  ``counts``,
    if given, accumulates the iterations run under ``"iterations"``."""
    L = lab0.shape[0]
    e_idx = inc_e.expand(L, -1)
    g_idx = inc_g.expand(L, -1)
    big = torch.full((), _BIG, dtype=torch.int32, device=lab0.device)
    gmin0 = torch.full((L, max(n_groups, 1)), _BIG, dtype=torch.int32,
                       device=lab0.device)

    def hop(lab):
        up = torch.where(alive_inc, lab.gather(1, e_idx), big)
        gmin = gmin0.clone().scatter_reduce_(1, g_idx, up, "amin")
        down = torch.where(alive_inc, gmin.gather(1, g_idx), big)
        return lab.scatter_reduce(1, e_idx, down, "amin")

    lab = lab0
    while True:
        before = lab
        for _ in range(LABEL_CHUNK):
            lab = hop(lab)
        if counts is not None:
            counts["iterations"] = counts.get("iterations", 0) + LABEL_CHUNK
        if torch.equal(lab, before):
            return lab


def _wing_conn_incidence(
    alive_e: torch.Tensor,  # (L, m) bool
    we1: torch.Tensor,
    we2: torch.Tensor,
    wp: torch.Tensor,
    n_pairs: int,
) -> torch.Tensor:
    """Per-level connective-wedge mask: wedge alive (both edges in the
    level subgraph) AND its pair holds ≥ 2 alive wedges — the pair then
    witnesses a butterfly joining every edge incident to it."""
    L = alive_e.shape[0]
    alive_w = alive_e[:, we1] & alive_e[:, we2]
    W = torch.zeros((L, max(n_pairs, 1)), dtype=torch.int32,
                    device=alive_e.device)
    W.index_add_(1, wp, alive_w.to(torch.int32))
    return alive_w & (W[:, wp] >= 2)


def _pad_block(x: np.ndarray, block: int) -> np.ndarray:
    """Pad the level axis up to ``block`` rows with all-dead levels
    (inert in the propagation), so every block has one shape and the
    caching allocator reuses its blocks."""
    pad = block - x.shape[0]
    if pad == 0:
        return x
    fill = np.zeros((pad,) + x.shape[1:], dtype=x.dtype)
    return np.concatenate([x, fill], axis=0)


def _component_labels_per_level(
    gg: BipartiteGraph,
    theta: np.ndarray,
    levels: np.ndarray,
    kind: str,
    level_block: int = 32,
    device="cuda",
    timings: Optional[Dict] = None,
) -> np.ndarray:
    """(L, n_entities) int64 component labels, _BIG-marked where dead.

    Levels go to the device in blocks of ``level_block`` (the last block
    padded with all-dead levels); the propagation state is
    O(level_block × incidences), and each block's labels come back to
    the host once.  ``timings``, if given, receives the seconds of the
    host wedge enumeration and the incidence upload (``incidence``) and
    the propagation iterations run (``iterations``)."""
    n_ent = gg.m if kind == "wing" else gg.n_u
    L = levels.size
    if L == 0 or n_ent == 0:
        return np.zeros((0, n_ent), dtype=np.int64)
    dev = torch.device(device)
    counts = {} if timings is None else timings
    t0 = time.perf_counter()

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    wed = csr.build_wedges(gg)
    if kind == "wing":
        we1 = t(wed.wedge_e1.astype(np.int64))
        we2 = t(wed.wedge_e2.astype(np.int64))
        wp = t(wed.wedge_pair.astype(np.int64))
        inc_e = torch.cat([we1, we2])
        inc_g = torch.cat([wp, wp])
        n_groups = wed.n_pairs
    else:
        # pairs with ≥ 2 wedges share a butterfly (V is never peeled, so
        # W0 is the pair's wedge count at every level)
        conn_p = wed.W0 >= 2
        pa = t(wed.pair_a[conn_p].astype(np.int64))
        pb = t(wed.pair_b[conn_p].astype(np.int64))
        pid = torch.arange(pa.numel(), dtype=torch.int64, device=dev)
        inc_e = torch.cat([pa, pb])
        inc_g = torch.cat([pid, pid])
        n_groups = int(pa.numel())
    del wed

    ids = torch.arange(n_ent, dtype=torch.int32, device=dev)[None, :]
    theta_d = t(theta)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    counts["incidence"] = time.perf_counter() - t0
    out = np.empty((L, n_ent), dtype=np.int64)
    for lo in range(0, L, level_block):
        chunk = levels[lo:lo + level_block]
        n = chunk.size
        ks = t(_pad_block(chunk, level_block))
        # padded levels get k = 0 rows; mark them dead explicitly
        alive = (theta_d[None, :] >= ks[:, None]) & (ks[:, None] > 0)
        if kind == "wing":
            conn = _wing_conn_incidence(alive, we1, we2, wp, n_groups)
            alive_inc = torch.cat([conn, conn], dim=1)
        else:
            ap = alive[:, pa] & alive[:, pb]
            alive_inc = torch.cat([ap, ap], dim=1)
        lab0 = torch.where(alive, ids, _BIG)
        lab = _label_components(alive_inc, inc_e, inc_g, lab0, n_ent,
                                n_groups, counts)
        out[lo:lo + n] = lab[:n].cpu().numpy().astype(np.int64)
    return out


# =====================================================================
# Host assembly: labels → packed forest
# =====================================================================
def _dfs_order(n_nodes: int, child_off, child_ids):
    """Preorder stamps (tin, tout) — iterative, root = node 0."""
    tin = np.zeros(n_nodes, dtype=np.int32)
    tout = np.zeros(n_nodes, dtype=np.int32)
    t = 0
    stack = [(0, False)]
    while stack:
        x, closing = stack.pop()
        if closing:
            tout[x] = t
            continue
        tin[x] = t
        t += 1
        stack.append((x, True))
        kids = child_ids[child_off[x]:child_off[x + 1]]
        for c in kids[::-1]:
            stack.append((int(c), False))
    return tin, tout


def build_hierarchy(
    g: BipartiteGraph,
    result: Union[PeelResult, np.ndarray],
    kind: str = "wing",
    side: str = "u",
    meta: Optional[Dict] = None,
    level_block: int = 32,
    device="cuda",
    timings: Optional[Dict] = None,
) -> Hierarchy:
    """Construct the k-wing / k-tip hierarchy forest from peel output.

    ``result`` is a :class:`~repro_torch.core.peelspec.PeelResult` or a
    raw θ array.  For ``kind="tip"`` pass the same ``side`` the
    decomposition peeled (the graph is transposed for ``side="v"``).
    Component labelling runs on ``device`` (default the card; ``"cpu"``
    runs it on the CPU); ``level_block`` caps how many levels are
    labelled at once — the forest is identical for any value ≥ 1.  A
    ``timings`` dict, if given, receives the seconds of the labelling
    (``labels``, of which ``incidence`` is the host wedge enumeration
    and upload), the propagation iterations run (``iterations``) and
    the seconds of the host assembly (``assembly``).  With the obs layer
    on, the build is a ``hierarchy.build`` span holding the
    ``hierarchy.labels`` and ``hierarchy.node_stats`` spans.
    """
    with obs.span("hierarchy.build", cat="hierarchy", kind=kind):
        return _build_hierarchy_impl(g, result, kind, side, meta,
                                     level_block, device, timings)


def _build_hierarchy_impl(g, result, kind, side, meta, level_block, device,
                          timings):
    if kind not in ("wing", "tip"):
        raise ValueError(kind)
    dev = resolve_device(device)
    gg = g if (kind == "wing" or side == "u") else g.transpose()
    if isinstance(result, PeelResult):
        theta = np.asarray(result.theta, dtype=np.int64)
        prov = result.provenance()
    else:
        theta = np.asarray(result, dtype=np.int64)
        prov = {}
    n_ent = gg.m if kind == "wing" else gg.n_u
    if theta.shape != (n_ent,):
        raise ValueError(
            f"theta has shape {theta.shape}, expected ({n_ent},) for "
            f"kind={kind!r}"
        )

    levels = np.unique(theta[theta > 0])
    t0 = time.perf_counter()
    with obs.span("hierarchy.labels", cat="hierarchy",
                  levels=int(levels.size)):
        labels = _component_labels_per_level(
            gg, theta, levels, kind, level_block=level_block, device=dev,
            timings=timings)
    t1 = time.perf_counter()
    h = _assemble_from_labels(gg, theta, levels, labels, kind, side, prov,
                              meta)
    if timings is not None:
        timings["labels"] = t1 - t0
        timings["assembly"] = time.perf_counter() - t1
    return h


def _assemble_from_labels(
    gg: BipartiteGraph,
    theta: np.ndarray,
    levels: np.ndarray,
    labels: np.ndarray,
    kind: str,
    side: str,
    prov: Dict,
    meta: Optional[Dict],
) -> Hierarchy:
    """Deterministic host assembly: per-level component labels → the
    packed forest, a pure function of ``(gg, theta, levels, labels)``
    (numpy, the JAX package's code)."""
    n_ent = gg.m if kind == "wing" else gg.n_u

    # ---- level-ascending node creation (collapsed chains)
    node_level = [0]
    parent = [-1]
    cur = np.zeros(n_ent, dtype=np.int32)       # deepest node so far
    entity_node = np.zeros(n_ent, dtype=np.int32)
    for li, k in enumerate(levels):
        lab = labels[li]
        alive = theta >= k
        own = theta == k
        own_roots = np.unique(lab[own])
        base = len(node_level)
        # parent BEFORE cur is updated: the deepest existing node that
        # contains the component's representative entity
        parent.extend(int(c) for c in cur[own_roots])
        node_level.extend([int(k)] * own_roots.size)
        remap = np.full(n_ent, -1, dtype=np.int64)
        remap[own_roots] = base + np.arange(own_roots.size)
        ali = np.where(alive)[0]
        mapped = remap[lab[ali]]
        hit = mapped >= 0
        cur[ali[hit]] = mapped[hit]
        entity_node[own] = cur[own]

    n_nodes = len(node_level)
    node_level = np.asarray(node_level, dtype=np.int64)
    parent = np.asarray(parent, dtype=np.int32)

    # ---- CSR packings
    member_cnt = np.bincount(entity_node, minlength=n_nodes)
    member_off = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(member_cnt, out=member_off[1:])
    member_ids = np.argsort(entity_node, kind="stable").astype(np.int32)

    child_cnt = np.bincount(parent[1:], minlength=n_nodes)
    child_off = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(child_cnt, out=child_off[1:])
    child_ids = (np.argsort(parent[1:], kind="stable") + 1).astype(np.int32)

    tin, tout = _dfs_order(n_nodes, child_off, child_ids)

    # ---- contiguous subtree slices: entities sorted by their node's tin
    ent_tin = tin[entity_node]
    ent_order = np.argsort(ent_tin, kind="stable").astype(np.int32)
    sorted_tin = ent_tin[ent_order]
    estart = np.searchsorted(sorted_tin, tin).astype(np.int64)
    eend = np.searchsorted(sorted_tin, tout).astype(np.int64)

    # ---- induced-subgraph stats per node
    node_m = np.zeros(n_nodes, dtype=np.int64)
    node_nu = np.zeros(n_nodes, dtype=np.int64)
    node_nv = np.zeros(n_nodes, dtype=np.int64)
    with obs.span("hierarchy.node_stats", cat="hierarchy",
                  n_nodes=int(n_nodes)):
        if kind == "wing":
            eu = gg.edges[:, 0]
            ev = gg.edges[:, 1]
            for x in range(n_nodes):
                ids = ent_order[estart[x]:eend[x]]
                node_m[x] = ids.size
                node_nu[x] = np.unique(eu[ids]).size
                node_nv[x] = np.unique(ev[ids]).size
        else:
            du, _ = gg.degrees()
            offu, nbru, _ = gg.csr_u()  # per-U CSR: neighbors are V ids
            for x in range(n_nodes):
                us = ent_order[estart[x]:eend[x]]
                node_nu[x] = us.size
                node_m[x] = int(du[us].sum())
                if us.size:
                    vs = np.concatenate(
                        [nbru[offu[u]:offu[u + 1]] for u in us]
                    )
                    node_nv[x] = np.unique(vs).size

    span = node_nu * node_nv
    density = np.divide(
        node_m, span, out=np.zeros(n_nodes, dtype=np.float64),
        where=span > 0, casting="unsafe",
    )

    info = dict(kind=kind, side=side, n_entities=int(n_ent))
    info.update(prov)
    if meta:
        info.update(meta)

    return Hierarchy(
        kind=kind,
        n_entities=n_ent,
        theta=theta,
        node_level=node_level,
        parent=parent,
        entity_node=entity_node,
        member_off=member_off,
        member_ids=member_ids,
        child_off=child_off,
        child_ids=child_ids,
        tin=tin,
        tout=tout,
        ent_order=ent_order,
        estart=estart,
        eend=eend,
        node_m=node_m,
        node_nu=node_nu,
        node_nv=node_nv,
        density=density,
        meta=info,
    )
