"""The benchmark's graphs: a frozen copy of the skewed-degree generator,
and the seeded relabelling that turns one graph into a run's input.

``powerlaw_edges`` repeats the arithmetic of the port's
``core.graph.powerlaw_bipartite`` (the same ``default_rng`` draws, the
same dedup and subsample), kept here so that a later change to the
port's generator cannot move the yardstick.
``portbench/tests/test_pb_inputs.py`` holds it to fixed digests.

A configuration's ``generate`` block fixes the graph (its sizes,
``alpha``, ``graph_seed``, and where the scale is cut, the users kept).
A run's ``--seed`` draws a permutation of the U ids and of the V ids
and an order of the edge list: every seed peels the same graph, up to
the names of its vertices, so every seed does the same work.
"""
from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["powerlaw_edges", "relabel", "user_subset", "make_graph",
           "edges_digest"]


def powerlaw_edges(n_u: int, n_v: int, m: int, alpha: float,
                   seed: int) -> np.ndarray:
    """(m', 2) int64 unique (u, v) pairs, sorted, m' <= m: vertex i of
    each side drawn with weight (i + 1) ** -alpha."""
    rng = np.random.default_rng(seed)
    pu = np.arange(1, n_u + 1, dtype=np.float64) ** (-alpha)
    pv = np.arange(1, n_v + 1, dtype=np.float64) ** (-alpha)
    pu /= pu.sum()
    pv /= pv.sum()
    u = rng.choice(n_u, size=3 * m, p=pu)
    v = rng.choice(n_v, size=3 * m, p=pv)
    e = np.unique(np.stack([u, v], axis=1), axis=0)
    if e.shape[0] > m:
        sel = rng.choice(e.shape[0], size=m, replace=False)
        e = e[np.sort(sel)]
    return e.astype(np.int64)


def user_subset(edges: np.ndarray, n_u: int, keep: int,
                seed: int) -> tuple:
    """Keep ``keep`` of the ``n_u`` users, drawn from ``seed``, and every
    edge between them and the other side; the kept users are renumbered
    0..keep-1 in their old order.  Returns (edges, keep)."""
    rng = np.random.default_rng(seed)
    kept = np.sort(rng.choice(n_u, size=keep, replace=False))
    new_id = np.full(n_u, -1, dtype=np.int64)
    new_id[kept] = np.arange(keep)
    e = edges[new_id[edges[:, 0]] >= 0]
    return np.stack([new_id[e[:, 0]], e[:, 1]], axis=1), keep


def relabel(edges: np.ndarray, n_u: int, n_v: int, seed: int) -> np.ndarray:
    """The run's copy of a graph: U and V ids permuted and the edge rows
    shuffled, all drawn from ``seed`` (any non-negative integer)."""
    rng = np.random.default_rng(seed)
    pu = rng.permutation(n_u)
    pv = rng.permutation(n_v)
    order = rng.permutation(edges.shape[0])
    e = edges[order]
    return np.stack([pu[e[:, 0]], pv[e[:, 1]]], axis=1).astype(np.int64)


def make_graph(config: dict, seed: int) -> tuple:
    """(n_u, n_v, edges) of a configuration (its ``generate`` block) for
    the run seed ``seed``."""
    graph = config["generate"]
    if graph["generator"] != "powerlaw_bipartite":
        raise ValueError(f"unknown generator {graph['generator']!r}")
    n_u, n_v = int(graph["n_u"]), int(graph["n_v"])
    e = powerlaw_edges(n_u, n_v, int(graph["m"]), float(graph["alpha"]),
                       int(graph["graph_seed"]))
    if "keep_users" in graph:
        e, n_u = user_subset(e, n_u, int(graph["keep_users"]),
                             int(graph["subset_seed"]))
    return n_u, n_v, relabel(e, n_u, n_v, seed)


def edges_digest(edges: np.ndarray) -> str:
    """sha256 of the edge rows as int64, in their order."""
    return hashlib.sha256(
        np.ascontiguousarray(edges, dtype=np.int64).tobytes()).hexdigest()
