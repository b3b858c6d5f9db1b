"""``BipartiteGraph.from_edges`` deduplicates and sorts through one
int64 key a row: its edges equal ``np.unique(edges, axis=0)`` (the JAX
package's constructor) on every input, and ids out of range still raise
``AssertionError``."""
import numpy as np
import pytest

from repro_torch.core.graph import BipartiteGraph


@pytest.mark.parametrize("n_u,n_v,m,seed", [
    (1, 1, 5, 0), (3, 7, 40, 1), (50, 2, 500, 2), (7, 1, 3, 3),
    (1000, 3000, 20000, 4), (2 ** 15, 2 ** 16 + 3, 5000, 5)])
def test_from_edges_equals_unique_rows(n_u, n_v, m, seed):
    rng = np.random.default_rng(seed)
    e = np.stack([rng.integers(0, n_u, m), rng.integers(0, n_v, m)], 1)
    e = np.concatenate([e, e[::3]])          # duplicates, out of order
    g = BipartiteGraph.from_edges(n_u, n_v, e)
    want = np.unique(e.astype(np.int32), axis=0)
    assert g.edges.dtype == np.int32 and g.edges.flags.c_contiguous
    assert np.array_equal(g.edges, want)
    assert g.build_seconds() > 0


def test_from_edges_of_no_edges():
    g = BipartiteGraph.from_edges(3, 4, np.zeros((0, 2), dtype=np.int64))
    assert g.edges.shape == (0, 2) and g.edges.dtype == np.int32


@pytest.mark.parametrize("bad,side", [([0, 4], "v"), ([3, 0], "u"),
                                      ([-1, 0], "u"), ([0, -1], "v")])
def test_from_edges_refuses_ids_out_of_range(bad, side):
    with pytest.raises(AssertionError, match=f"{side} id out of range"):
        BipartiteGraph.from_edges(3, 4, np.array([[1, 1], bad]))
