"""Plain wing decomposition: a level-synchronous bottom-up peel of the
edges (NumPy only, dense 0/1 adjacency).

With A the (n_u, n_v) adjacency and M = A^T A, the butterflies through
an edge (u, v) are (A M)[u, v] - d_u - d_v + 1: the paths u-v'-u'-v
closed by (u, v), less those with u' = u or v' = v.  Each round raises k
to the least support among the surviving edges, gives every survivor
with support <= k the wing number k, removes them together (A' = A - D)
and updates P = A M to A' M' exactly:

    P' = P - D M - A' dM,   dM = M - M',

where dM is non-zero only in the rows and columns of the removed edges'
V vertices.  Every product is of 0/1 matrices and counts, exact in
float32 below 2**24 (n_u * n_v bounds every entry; checked).

``significand_bits`` (the control only) rounds every support to a float
of that many significand bits after each update.
"""
from __future__ import annotations

import numpy as np

from .rounding import round_significand

__all__ = ["wing_numbers"]


def wing_numbers(n_u: int, n_v: int, edges: np.ndarray,
                 significand_bits: int = 0) -> np.ndarray:
    """(m,) int64 wing numbers of ``edges`` ((m, 2) distinct (u, v)
    rows), in row order.  ``significand_bits`` > 0 (the control only)
    rounds every support to that many significand bits after each
    update."""
    if n_u * n_v >= 1 << 24:
        raise ValueError("dense float32 counts are exact only while "
                         "n_u * n_v < 2**24")
    eu = edges[:, 0].astype(np.int64)
    ev = edges[:, 1].astype(np.int64)
    m = eu.size
    A = np.zeros((n_u, n_v), dtype=np.float32)
    A[eu, ev] = 1.0
    M = A.T @ A
    P = A @ M
    du = A.sum(axis=1).astype(np.int64)
    dv = A.sum(axis=0).astype(np.int64)

    def supports(idx):
        u, v = eu[idx], ev[idx]
        return round_significand(
            P[u, v].astype(np.int64) - du[u] - dv[v] + 1, significand_bits)

    theta = np.zeros(m, dtype=np.int64)
    k = 0
    live = np.arange(m)
    sup = supports(live)
    while live.size:
        k = max(k, int(sup.min()))
        out = sup <= k
        gone = live[out]
        theta[gone] = k
        ru, rv = eu[gone], ev[gone]
        A[ru, rv] = 0.0
        np.subtract.at(du, ru, 1)
        np.subtract.at(dv, rv, 1)
        vr = np.unique(rv)
        M_rows = A[:, vr].T @ A                      # rows vr of M'
        dM = M[vr] - M_rows                          # (|vr|, n_v)
        # - D M: each removed (u, v) takes M[v] from row u
        np.subtract.at(P, ru, M[rv])
        # - A' dM: dM holds the rows vr and, transposed, the columns vr
        # of M - M'; the block vr x vr lies in both and is taken once
        P -= A[:, vr] @ dM
        P[:, vr] -= A @ dM.T - A[:, vr] @ dM[:, vr].T
        M[vr] = M_rows
        M[:, vr] = M_rows.T
        live = live[~out]
        sup = supports(live)
    return theta
