"""The dense engine's counts past float32's exact range, on the CPU.

The graph: 200 users × 800 items at density 0.75 (seeded; user r's row
density rises from 0.5 to 1 with r, so that the tip numbers spread over
63 levels), where 131 users' butterfly counts lie past 2²⁴, 66 of them
odd, which float32 cannot hold.  The port counts them in int64 (the plain
versions here; the ``vertex_count`` kernel's int64 accumulator on the
card, ``tests/test_torch_cuda.py``) and carries the dense tip engine's
pair cascades in float64, so ⋈init and θ equal the benchmark's plain
NumPy/SciPy reference (``portbench/reference/tip.py``) integer for
integer.  The JAX package, whose dense engine stops at 2²⁴, is not
imported: the reference is the plain peel.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import counting, peel
from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.peel import tip_decomposition
from repro_torch.kernels import ops, ref
from repro_torch.kernels.butterfly_count import vertex_count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.reference import tip as ref_tip  # noqa: E402

torch.set_num_threads(1)

N_U, N_V, DENSITY, SEED = 200, 800, 0.75, 0


def dense_graph():
    """(A as int64 numpy, BipartiteGraph) of the seeded dense graph: row
    r has density 0.5 + 0.5·r/(N_U − 1), 0.75 over the whole."""
    rows = np.linspace(2 * DENSITY - 1, 1, N_U)[:, None]
    A = np.random.default_rng(SEED).random((N_U, N_V)) < rows
    return A.astype(np.int64), BipartiteGraph.from_edges(
        N_U, N_V, np.argwhere(A).astype(np.int64))


def pair_matrix(A: np.ndarray) -> np.ndarray:
    """int64 C(W, 2) with a zero diagonal, W = A·Aᵀ, in int64 NumPy."""
    W = A @ A.T
    np.fill_diagonal(W, 0)
    return W * (W - 1) // 2


def numpy_counts(A: np.ndarray) -> np.ndarray:
    """int64 Σ_{j≠r} C(W[r, j], 2), W = A·Aᵀ, all in int64 NumPy."""
    return pair_matrix(A).sum(axis=1)


def fd_initial_supports(C: np.ndarray, part: np.ndarray) -> np.ndarray:
    """What CD leaves each user for its partition's FD: ⋈init less the
    pair butterflies shared with every user of an earlier partition."""
    earlier = part[None, :] < part[:, None]
    return C.sum(axis=1) - (C * earlier).sum(axis=1)


@pytest.fixture(scope="module")
def graph():
    A, g = dense_graph()
    want = numpy_counts(A)
    # the graph is what the tests need: counts past 2**24, some odd
    big = want >= 2 ** 24
    assert int(big.sum()) == 131 and int((want[big] % 2).sum()) == 66
    return A, g, want


def test_plain_vertex_count_is_int64_and_exact(graph):
    A, _, want = graph
    At = torch.from_numpy(A.astype(np.float32))
    for got in (ref.vertex_butterflies_ref(At), vertex_count(At),
                ops.vertex_butterflies(At), counting.vertex_butterflies(At),
                counting.vertex_butterflies_blocked(At, block=48),
                ops.vertex_butterflies_tiled(At, tile_rows=128)):
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want)
    assert int(counting.total_butterflies(At)) * 2 == int(want.sum())


def test_float32_sums_round_on_this_graph(graph):
    """The same sums taken in float32, as the JAX package takes them,
    lose the odd counts: the int64 test above can fail."""
    A, _, want = graph
    W = torch.from_numpy(A.astype(np.float32))
    W = W @ W.T
    W.fill_diagonal_(0.0)
    f32 = torch.sum(W * (W - 1.0) * 0.5, dim=1).numpy().astype(np.int64)
    assert not np.array_equal(f32, want)
    big = want >= 2 ** 24
    assert not (f32[big] % 2).any()


def test_pair_cascade_is_exact_past_2_24(graph):
    """The CD and FD deltas: the float64 pair matrix times a peeled set.
    With all but three users peeled, those three lose sums past 2**24."""
    A, _, _ = graph
    pair = peel._pair_butterflies(torch.from_numpy(A.astype(np.float32)))
    assert pair.dtype == torch.float64
    S = np.ones(N_U, dtype=bool)
    S[-3:] = False
    got = peel._tip_fd_delta(pair, torch.from_numpy(S))
    want = pair_matrix(A) @ S.astype(np.int64)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert int(want[-3:].min()) >= 2 ** 24
    assert int((want[-3:] % 2).sum()) > 0


@pytest.mark.parametrize("batch_recount", ["adaptive", True, False])
@pytest.mark.parametrize("P", [8, 16])
def test_dense_tip_equals_the_reference(graph, batch_recount, P):
    A, g, want = graph
    res = tip_decomposition(g, side="u", P=P, engine="dense",
                            batch_recount=batch_recount, device="cpu")
    edges = np.argwhere(A).astype(np.int64)
    sup = np.asarray(ref_tip.pair_butterflies(N_U, N_V, edges).sum(axis=1))
    assert np.array_equal(sup.ravel(), want)
    # CD's cascade, checked where it ends: each partition's supports
    assert res.stats.p_effective > 1
    assert np.array_equal(np.asarray(res.support_init, np.int64),
                          fd_initial_supports(pair_matrix(A), res.part))
    assert np.array_equal(np.asarray(res.theta, np.int64),
                          ref_tip.tip_numbers(N_U, N_V, edges))


@pytest.mark.parametrize("dtype,limit", [(torch.int64, 2 ** 53),
                                         (torch.float64, 2 ** 53),
                                         (torch.float32, 2 ** 24)])
def test_assert_exact_raises_at_the_limit_of_the_type(dtype, limit):
    counting.assert_exact(torch.tensor([0, limit - 1], dtype=dtype))
    for bad in (limit, -limit):
        with pytest.raises(OverflowError, match="exact range"):
            counting.assert_exact(torch.tensor([1, bad], dtype=dtype))


def test_dense_spec_times_the_pair_matrix_apart(graph):
    _, g, _ = graph
    res = tip_decomposition(g, side="u", P=4, engine="dense", device="cpu")
    assert res.seconds["spec.pairs"] > 0
    assert res.seconds["spec.supports"] > 0
    # every round and pack of the FD is counted in fd.pack and fd
    assert res.seconds["fd.pack"] <= res.seconds["fd"]


def host_fd_cascade(C: np.ndarray, part: np.ndarray, sup: np.ndarray):
    """Each partition's bottom-up peel in int64 NumPy, round by round (the
    JAX package's host loop): θ, the rounds of each partition and their
    (k, died, frontier) records."""
    theta = np.full(part.size, -1, dtype=np.int64)
    rounds, recs = [], []
    for p in range(int(part.max()) + 1):
        rows = np.where(part == p)[0]
        Cp, s = C[np.ix_(rows, rows)], sup[rows].copy()
        alive = np.ones(rows.size, dtype=bool)
        k, rec = 0, []
        while alive.any():
            k = max(k, int(s[alive].min()))
            while (S := alive & (s <= k)).any():
                theta[rows[S]] = k
                alive &= ~S
                s -= Cp[:, S].sum(axis=1)
                rec.append((k, int(S.sum()), int(alive.sum())))
        rounds.append(len(rec))
        recs.append(rec)
    return theta, rounds, recs


@pytest.mark.parametrize("P", [1, 3, 16])
def test_fd_tip_dense_plain_equals_the_host_cascade(graph, P):
    """The FD phase's plain version (what the ``fd_tip_dense`` kernel
    computes) against the round-by-round host loop, on supports past
    2**24: θ, each partition's rounds and each round's record."""
    A, _, want = graph
    C = pair_matrix(A)
    part = np.random.default_rng(P).integers(0, P, N_U)
    part[:P] = np.arange(P)          # no partition empty
    sup = fd_initial_supports(C, part)
    assert int(sup.max()) >= 2 ** 24
    order = np.argsort(part, kind="stable")
    off = np.concatenate([[0], np.cumsum(np.bincount(part, minlength=P))])
    theta, rounds, rec = ops.fd_tip_dense(
        peel._pair_butterflies(torch.from_numpy(A.astype(np.float32))),
        torch.from_numpy(order.astype(np.int32)), torch.from_numpy(off),
        torch.from_numpy(sup[order]))
    want_theta, want_rounds, want_recs = host_fd_cascade(C, part, sup)
    got = np.empty(N_U, dtype=np.int64)
    got[order] = theta.numpy()
    assert np.array_equal(got, want_theta)
    assert rounds.tolist() == want_rounds
    for p in range(P):
        r = want_rounds[p]
        assert rec[off[p]:off[p] + r].tolist() == [list(x) for x in
                                                    want_recs[p]]
        assert not rec[off[p] + r:off[p + 1]].any()
