"""Applications of PBNG inside an LM system — the port of the JAX
package's ``core/analysis.py`` on the port's peel.

* ``moe_affinity``  — tip-decompose the token×expert routing graph of a
  mixture-of-experts layer: experts with high tip numbers form densely
  co-activated groups (candidates for co-location on a device).
* ``interaction_curriculum`` — wing-decompose a user×item graph and bucket
  edges by wing-number level: a dense-subgraph curriculum for
  link-prediction training data (the paper's e-commerce use case).

The peels take the JAX package's defaults (``tip_decomposition``'s
``dense`` engine on side v, ``wing_decomposition(engine="beindex")``) and
run on ``device``; the level code is the JAX package's numpy.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .graph import BipartiteGraph
from .peel import tip_decomposition, wing_decomposition

__all__ = ["moe_affinity", "interaction_curriculum", "routing_graph"]


def routing_graph(assignments: np.ndarray, n_experts: int) -> BipartiteGraph:
    """Token×expert bipartite graph from a router's top-k assignments.

    assignments: (tokens, k) int expert ids.
    """
    t = np.repeat(np.arange(assignments.shape[0]), assignments.shape[1])
    e = assignments.reshape(-1)
    return BipartiteGraph.from_edges(
        int(assignments.shape[0]), int(n_experts), np.stack([t, e], axis=1)
    )


def moe_affinity(
    assignments: np.ndarray, n_experts: int, P: int = 8, device="cuda"
) -> np.ndarray:
    """Per-expert tip numbers of the routing graph.

    High tip number ⇔ the expert participates in many butterflies ⇔ it is
    frequently co-activated with other experts on shared tokens.  Experts
    in the same high-k tip are good candidates for the same EP shard.
    """
    g = routing_graph(assignments, n_experts)
    return tip_decomposition(g, side="v", P=P, device=device).theta


def interaction_curriculum(
    g: BipartiteGraph, n_levels: int = 4, P: int = 8, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """Bucket edges into ``n_levels`` density levels by wing number.

    Returns (level per edge, level boundaries).  Level n_levels−1 is the
    densest community core — the curriculum feeds dense levels first for
    link-prediction pretraining (paper §1 applications).
    """
    theta = wing_decomposition(g, P=P, engine="beindex", device=device).theta
    return curriculum_levels(theta, n_levels)


def curriculum_levels(theta: np.ndarray, n_levels: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(level per edge, level boundaries) of wing numbers ``theta``: the
    JAX package's quantile buckets."""
    qs = np.quantile(theta, np.linspace(0, 1, n_levels + 1)[1:-1])
    bounds = np.unique(np.concatenate([[0], qs, [theta.max() + 1]]))
    level = np.clip(np.searchsorted(bounds, theta, side="right") - 1, 0,
                    n_levels - 1)
    return level.astype(np.int32), bounds.astype(np.int64)
