"""Plain tip decomposition: a level-synchronous bottom-up peel of one
side's vertices (NumPy and SciPy only).

Two vertices u, u' of the peeled side with c common neighbours share
C(c, 2) butterflies, and every butterfly has exactly two of them.  So
removing a set R of vertices at once takes from each survivor u exactly
sum over r in R of C(c(u, r), 2), with no double count.  Each round
raises k to the least support among the survivors, gives every survivor
with support <= k the tip number k, and removes them together.

The benchmark's control changes only the supports' arithmetic: it
rounds every support to a narrower float after each update.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .rounding import round_significand

__all__ = ["pair_butterflies", "tip_numbers"]


def pair_butterflies(n_u: int, n_v: int, edges: np.ndarray) -> sp.csr_matrix:
    """(n_u, n_u) int64 CSR of C(c(u, u'), 2) off the diagonal, where c
    counts the common neighbours of u and u'."""
    A = sp.csr_matrix((np.ones(edges.shape[0], dtype=np.int64),
                       (edges[:, 0], edges[:, 1])), shape=(n_u, n_v))
    C = (A @ A.T).tocsr()
    C.setdiag(0)
    C.eliminate_zeros()
    C.data = C.data * (C.data - 1) // 2
    C.eliminate_zeros()
    return C


def tip_numbers(n_u: int, n_v: int, edges: np.ndarray,
                significand_bits: int = 0) -> np.ndarray:
    """(n_u,) int64 tip numbers of the U side of the graph
    (``edges``: (m, 2) distinct (u, v) rows).  ``significand_bits`` > 0
    (the control only) rounds every support to a float of that many
    significand bits after each update."""
    B = pair_butterflies(n_u, n_v, edges)
    sup = round_significand(np.asarray(B.sum(axis=1)).ravel()
                            .astype(np.int64), significand_bits)
    alive = np.ones(n_u, dtype=bool)
    theta = np.zeros(n_u, dtype=np.int64)
    k = 0
    left = n_u
    while left:
        live = np.flatnonzero(alive)
        k = max(k, int(sup[live].min()))
        peel = live[sup[live] <= k]
        theta[peel] = k
        alive[peel] = False
        left -= peel.size
        loss = np.asarray(B[peel].sum(axis=0)).ravel()
        sup = round_significand(sup - loss, significand_bits)
    return theta
