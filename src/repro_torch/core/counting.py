"""Butterfly counting as dense linear algebra, in PyTorch.

The paper counts butterflies by traversing wedges with per-thread
hashmaps (alg.1).  The dense engine replaces the traversal with matrix
products:

    W = A · Aᵀ                      (wedge counts between same-side pairs)
    ⋈_u = Σ_{u'≠u} C(W[u,u'], 2)    (per-vertex butterflies)
    ⋈_e = ((W−1)·A)[u,v] − (d_u−1)  (per-edge butterflies)

All functions take an ``alive``-masked adjacency so the same code performs
the paper's §5.1 batch *re-counting* during peeling.  The port of the JAX
package's ``core/counting.py``; the products stay ``torch.matmul``, as
the reference leaves them to ``lax.dot`` outside any kernel, except the
per-vertex count on a CUDA tensor, which is the int8 ``vertex_count``
kernel (``kernels.ops.vertex_butterflies``; the hand-written kernels of
the per-edge count are ``kernels.ops.edge_wedge_matrix``).

Every count is an exact integer.  W = A·Aᵀ is exact in float32 (its
entries are common-neighbour counts, at most n_v < 2²⁴).  The per-vertex
butterflies (``vertex_butterflies``, its blocked route,
``recount_vertex``, ``total_butterflies``) are int64: C(W, 2) and the
row sums are taken in int64 on the CPU, and in the kernel's int64
accumulator on the card, so they do not round where the JAX package's
float32 sums do (past 2²⁴).  The per-edge counts stay float32, exact
below 2²⁴.  ``assert_exact`` guards each type at its limit: 2²⁴ for
float32; 2⁵³ for float64 and for int64, whose sums the dense tip engine
carries through float64 products.  Every float32 product runs in full
float32 (``matmul_f32``): TF32 would round the counts.
"""
from __future__ import annotations

import os

import torch

from .. import obs
from ..kernels import ops, ref
from ..kernels.ref import matmul_f32

__all__ = [
    "wedge_counts",
    "vertex_butterflies",
    "edge_butterflies",
    "total_butterflies",
    "vertex_wedge_workload",
    "masked_adjacency",
    "vertex_butterflies_blocked",
    "recount_vertex",
    "assert_exact",
    "approx_vertex_butterflies",
]


def masked_adjacency(shape, edges: torch.Tensor,
                     alive_e: torch.Tensor) -> torch.Tensor:
    """Adjacency with only alive edges set (for wing peeling)."""
    A = torch.zeros(shape, dtype=torch.float32, device=edges.device)
    return A.index_put_((edges[:, 0], edges[:, 1]),
                        alive_e.to(torch.float32), accumulate=True)


def wedge_counts(A: torch.Tensor) -> torch.Tensor:
    """W[i, j] = number of common neighbours of rows i and j."""
    return matmul_f32(A, A.T)


def _dense_limit() -> int:
    """Element budget for materializing the full n×n wedge matrix W
    (shared knob with the dense peel engine's guard)."""
    return int(os.environ.get("REPRO_DENSE_MAX_ELEMS", str(2 ** 28)))


def vertex_butterflies(A: torch.Tensor, block: int = 512) -> torch.Tensor:
    """int64 ⋈ for every row vertex of A (mask rows for tip peeling).

    On a CUDA tensor the ``vertex_count`` kernel counts them
    (``ops.vertex_butterflies``, looked up at call time; A must be 0/1):
    it never stores W, so it needs no blocked route.  On the CPU, when
    the full wedge matrix W = A·Aᵀ would exceed ``REPRO_DENSE_MAX_ELEMS``
    elements, the reduction routes itself through the row-blocked path
    (:func:`vertex_butterflies_blocked`, O(block·n) peak) instead of
    failing; W is only ever consumed as row sums here, so the tiling is
    exact and invisible to callers.  An obs ``counting.tiles`` counter
    records when it fires."""
    if A.device.type == "cuda":
        return ops.vertex_butterflies(A)
    n = A.shape[0]
    if n * n > _dense_limit():
        obs.counter("counting.tiles", dict(
            tiles=-(-n // block), block=block, rows=n))
        return vertex_butterflies_blocked(A, block=block)
    return ref.vertex_butterflies_ref(A)


def vertex_butterflies_blocked(A: torch.Tensor,
                               block: int = 512) -> torch.Tensor:
    """Row-blocked variant — O(block·n) peak memory instead of O(n²);
    int64."""
    n = A.shape[0]
    out = torch.empty((n,), dtype=torch.int64, device=A.device)
    cols = torch.arange(n, device=A.device)
    for r0 in range(0, n, block):
        blk = A[r0:r0 + block]
        W = matmul_f32(blk, A.T)
        rows = torch.arange(r0, r0 + blk.shape[0], device=A.device)
        W = torch.where(rows[:, None] == cols[None, :], 0.0, W)
        out[r0:r0 + blk.shape[0]] = ref.choose2_row_sums(W)
    return out


def edge_butterflies(A: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """⋈_e for the edge list (entries for dead edges are garbage — mask
    downstream).  A must already be alive-masked."""
    du = torch.sum(A, dim=1)
    M = ref.edge_wedge_matrix_ref(A)
    u, v = edges[:, 0], edges[:, 1]
    return M[u, v] - (du[u] - 1.0)


def total_butterflies(A: torch.Tensor) -> torch.Tensor:
    """⋈(G), int64: each butterfly counts once per U endpoint, so
    halve."""
    return torch.sum(vertex_butterflies(A)) // 2


def vertex_wedge_workload(A: torch.Tensor) -> torch.Tensor:
    """Σ_{v∈N_u} d_v — the paper's workload proxy for tip range selection."""
    dv = torch.sum(A, dim=0)
    return matmul_f32(A, dv)


def recount_vertex(shape, A: torch.Tensor,
                   alive_u: torch.Tensor) -> torch.Tensor:
    """Batch re-count for tip CD: butterflies among alive row vertices
    (int64)."""
    Am = A * alive_u[:, None].to(A.dtype)
    return vertex_butterflies(Am)


# the exclusive limit of exact integer counts in each type that carries
# them: float32's significand; float64's; int64 counts feed the dense
# tip engine's float64 pair-butterfly products, so float64's
_EXACT_BELOW = {torch.float32: ("f32", 2 ** 24),
                torch.float64: ("float64", 2 ** 53),
                torch.int64: ("float64", 2 ** 53)}


def assert_exact(x: torch.Tensor) -> None:
    """Counts must stay inside the exact-integer range of the type that
    carries them (``_EXACT_BELOW``); raises ``OverflowError`` at the
    limit, so a count is never rounded."""
    name, limit = _EXACT_BELOW[x.dtype]
    if bool(torch.any(torch.abs(x) >= limit)):
        raise OverflowError(
            f"butterfly counts exceed {name} exact range (2^"
            f"{limit.bit_length() - 1}); use the csr engine"
        )


def approx_vertex_butterflies(
    A: torch.Tensor, n_cols: int, generator: torch.Generator,
    n_rounds: int = 4,
) -> torch.Tensor:
    """Column-sampled butterfly estimate (FLEET-style [49] sampling).

    Each round samples ``n_cols`` V-columns without replacement (a
    ``torch.randperm`` prefix drawn from ``generator``); with
    X ~ Hypergeometric(n_v, W, n_cols) common-neighbour survivors,
    E[X(X−1)] = W(W−1)·n(n−1)/(N(N−1)), giving the unbiased estimator
    C2 ≈ X(X−1)/2 · N(N−1)/(n(n−1)).  Estimates average over
    ``n_rounds`` draws.  Used only for CD *range estimation* on huge
    graphs, never for final θ.  The JAX package draws its columns with
    ``jax.random``; the two give different columns from one seed.
    """
    n_u, n_v = A.shape
    n_cols = min(n_cols, n_v)
    scale = (n_v * (n_v - 1)) / (n_cols * (n_cols - 1))

    def one():
        cols = torch.randperm(n_v, generator=generator,
                              device=generator.device)[:n_cols]
        X = wedge_counts(A[:, cols.to(A.device)])
        X.fill_diagonal_(0.0)
        return torch.sum(X * (X - 1.0), dim=1) * 0.5 * scale

    return torch.mean(torch.stack([one() for _ in range(n_rounds)]), dim=0)
