"""Plain tip hierarchy and its query answers (NumPy, SciPy and a
union-find in Python).

The k-tip subgraph holds the peeled side's vertices with tip number
theta >= k.  Two of them are joined at level k when both are in it and
they have at least two common neighbours (so they share a butterfly;
the other side is never peeled).  The hierarchy's nodes are the
components of the k-subgraphs, for every level k that some vertex has,
that hold a vertex with theta == k.  They are numbered from 1 by level,
then by the least vertex id of the component; node 0 is the root at
level 0.  A node's parent is the node of the highest lower level whose
component holds it, else the root.  A vertex belongs to the node of its
own level that holds it (the root where theta == 0).

This module builds that forest by descending the levels with a
union-find, not by labelling each level, and answers the five query
kinds: ``max_k``, ``node_of``, ``lca_node``, ``lca_level`` and
``subtree_size``.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["OPS", "tip_forest", "answers"]

# op code -> query kind, as the service under test numbers them
OPS = ("max_k", "node_of", "lca_node", "lca_level", "subtree_size")


def _joined_pairs(n_u: int, n_v: int, edges: np.ndarray):
    """(x, y) with x < y: U pairs with at least two common neighbours."""
    A = sp.csr_matrix((np.ones(edges.shape[0], dtype=np.int64),
                       (edges[:, 0], edges[:, 1])), shape=(n_u, n_v))
    C = sp.triu(A @ A.T, k=1).tocoo()
    keep = C.data >= 2
    return C.row[keep].astype(np.int64), C.col[keep].astype(np.int64)


def tip_forest(n_u: int, n_v: int, edges: np.ndarray,
               theta: np.ndarray) -> dict:
    """The tip hierarchy of the U side for tip numbers ``theta``:
    ``node_level``, ``parent`` (-1 at the root), ``entity_node``,
    ``depth`` and ``size`` (vertices in each node's subtree)."""
    theta = np.asarray(theta, dtype=np.int64)
    x, y = _joined_pairs(n_u, n_v, edges)
    w = np.minimum(theta[x], theta[y])
    order = np.argsort(-w, kind="stable")
    x, y, w = x[order], y[order], w[order]

    root = list(range(n_u))
    low = list(range(n_u))          # least vertex id of each component
    pending = [[] for _ in range(n_u)]  # nodes waiting for their parent

    def find(a):
        while root[a] != a:
            root[a] = root[root[a]]
            a = root[a]
        return a

    levels = np.unique(theta[theta > 0])[::-1]
    pos = np.flatnonzero(theta > 0)
    srt = pos[np.argsort(theta[pos], kind="stable")]
    lo = np.searchsorted(theta[srt], levels, side="left")
    hi = np.searchsorted(theta[srt], levels, side="right")
    by_level = {int(k): srt[i:j] for k, i, j in zip(levels, lo, hi)}

    keys = []            # (level, least id) of each node, creation order
    parent_of = {}       # creation index -> parent creation index
    member_node = np.full(n_u, -1, dtype=np.int64)  # creation index
    j = 0
    n_pairs = w.size
    for k in levels.tolist():
        while j < n_pairs and w[j] >= k:
            a, b = find(int(x[j])), find(int(y[j]))
            j += 1
            if a == b:
                continue
            if len(pending[a]) < len(pending[b]):
                a, b = b, a
            root[b] = a
            low[a] = min(low[a], low[b])
            pending[a].extend(pending[b])
            pending[b] = []
        made = {}
        for v in by_level[k].tolist():
            r = find(v)
            if r not in made:
                idx = len(keys)
                keys.append((k, low[r]))
                for c in pending[r]:
                    parent_of[c] = idx
                pending[r] = [idx]
                made[r] = idx
            member_node[v] = made[r]

    # number the nodes by (level, least id); the root is node 0
    rank = sorted(range(len(keys)), key=lambda i: keys[i])
    node_id = np.empty(len(keys), dtype=np.int64)
    node_id[rank] = np.arange(1, len(keys) + 1)
    n_nodes = len(keys) + 1
    node_level = np.zeros(n_nodes, dtype=np.int64)
    parent = np.full(n_nodes, -1, dtype=np.int64)
    for i, (k, _) in enumerate(keys):
        node_level[node_id[i]] = k
        parent[node_id[i]] = node_id[parent_of[i]] if i in parent_of else 0
    entity_node = np.where(member_node >= 0,
                           node_id[np.maximum(member_node, 0)], 0)

    depth = np.zeros(n_nodes, dtype=np.int64)
    for v in range(1, n_nodes):          # parents precede their children
        depth[v] = depth[parent[v]] + 1
    size = np.bincount(entity_node, minlength=n_nodes).astype(np.int64)
    for v in range(n_nodes - 1, 0, -1):
        size[parent[v]] += size[v]
    return dict(node_level=node_level, parent=parent,
                entity_node=entity_node.astype(np.int64), depth=depth,
                size=size, theta=theta)


def _lca(forest: dict, p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Lowest common ancestors of node pairs, by climbing parents."""
    parent, depth = forest["parent"], forest["depth"]
    while True:
        p = np.where(depth[p] > depth[q], parent[p], p)
        q = np.where(depth[q] > depth[p], parent[q], q)
        level = depth[p] == depth[q]
        if level.all() and (p == q).all():
            return p
        step = level & (p != q)
        p = np.where(step, parent[p], p)
        q = np.where(step, parent[q], q)


def answers(forest: dict, ops: np.ndarray, a: np.ndarray,
            b: np.ndarray) -> np.ndarray:
    """int64 answers of queries (op codes as in :data:`OPS`)."""
    ops = np.asarray(ops)
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    out = np.full(ops.shape, -1, dtype=np.int64)
    ent = ops != OPS.index("subtree_size")
    ea = np.where(ent, a, 0)
    eb = np.where(ent, b, 0)
    na = np.where(ent, 0, a)
    pick = {
        "max_k": lambda: forest["theta"][ea],
        "node_of": lambda: forest["entity_node"][ea],
        "subtree_size": lambda: forest["size"][na],
    }
    for code, name in enumerate(OPS):
        sel = ops == code
        if name in pick:
            out[sel] = pick[name]()[sel]
    pair = (ops == OPS.index("lca_node")) | (ops == OPS.index("lca_level"))
    if pair.any():
        en = forest["entity_node"]
        lca = _lca(forest, en[ea[pair]], en[eb[pair]])
        level = forest["node_level"][lca]
        is_node = ops[pair] == OPS.index("lca_node")
        out[pair] = np.where(is_node, lca, level)
    return out
