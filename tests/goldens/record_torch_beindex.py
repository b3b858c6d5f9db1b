"""Record the JAX package's BE-Index on small graphs, for the port's card
tests.

``tests/test_torch_cuda.py`` builds the port's BE-Index on the card and
holds it to the index written here (the card's machine has no JAX);
``tests/test_torch_engines.py`` holds this file to the JAX package and
builds the port's index on the CPU from the same edges.  Recorded, each
with its edge list as the graph holds it and the index's sizes and the
sha256 of each int32 array:

* ``rb30``, ``rb25``, ``pl80``, ``pl60``, ``numpy`` — the graphs of
  ``test_torch_engines.py::test_build_beindex_equals_reference``;
* ``no_edges`` and ``no_butterflies`` (wedges, but no 4-cycle: an empty
  index), ``isolated_and_degree1`` (a K3,3 with pendant edges, an
  isolated edge and isolated vertices on both sides), ``tied_degrees``
  (every vertex of both sides of degree 3: priority falls back to ids)
  and ``unsorted_rows`` (edge rows in a shuffled order, which fixes the
  order of each vertex's neighbours).

Run from the repository root (seconds, CPU)::

    PYTHONPATH=src python tests/goldens/record_torch_beindex.py
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from repro.core.beindex import build_beindex
from repro.core.graph import (BipartiteGraph, powerlaw_bipartite,
                              random_bipartite)

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_beindex.json")
BE_ARRAYS = ("bloom_k", "link_edge", "link_twin", "link_bloom")


def graphs() -> dict:
    """name -> the JAX package's graph."""
    rng = np.random.default_rng(7)
    raw = np.stack([rng.integers(0, 25, 160), rng.integers(0, 19, 160)], 1)
    k33 = [(u, v) for u in range(3) for v in range(3)]
    shuffled = BipartiteGraph.from_edges(12, 10, np.stack(
        [np.random.default_rng(11).integers(0, 12, 60),
         np.random.default_rng(12).integers(0, 10, 60)], 1)).edges
    shuffled = shuffled[np.random.default_rng(13).permutation(len(shuffled))]
    return {
        "rb30": random_bipartite(30, 24, 140, seed=0),
        "rb25": random_bipartite(25, 20, 100, seed=1),
        "pl80": powerlaw_bipartite(80, 40, 350, seed=2),
        "pl60": powerlaw_bipartite(60, 50, 300, seed=3),
        "numpy": BipartiteGraph.from_edges(25, 19, raw),
        "no_edges": BipartiteGraph.from_edges(3, 4, np.zeros((0, 2))),
        "no_butterflies": BipartiteGraph.from_edges(4, 5, [
            (0, 0), (0, 1), (0, 2), (0, 3), (1, 4), (2, 4), (3, 3)]),
        "isolated_and_degree1": BipartiteGraph.from_edges(7, 6, k33 + [
            (3, 0), (4, 3), (5, 1)]),
        "tied_degrees": BipartiteGraph.from_edges(6, 6, [
            (u, (u + k) % 6) for u in range(6) for k in range(3)]),
        "unsorted_rows": BipartiteGraph(12, 10, shuffled),
    }


def index_digest(be) -> dict:
    """The index's sizes and the sha256 of each array's bytes."""
    out = dict(nb=int(be.nb), n_links=int(be.n_links))
    out.update({f"{k}_sha256": hashlib.sha256(
        np.ascontiguousarray(getattr(be, k)).tobytes()).hexdigest()
        for k in BE_ARRAYS})
    return out


def main() -> None:
    rec = {}
    for name, g in graphs().items():
        rec[name] = dict(n_u=g.n_u, n_v=g.n_v, edges=g.edges.tolist(),
                         index=index_digest(build_beindex(g)))
        print(name, rec[name]["index"]["nb"], rec[name]["index"]["n_links"])
    with open(OUT, "w") as f:   # one graph a line
        f.write("{\n" + ",\n".join(f"{json.dumps(k)}: {json.dumps(v)}"
                                   for k, v in rec.items()) + "\n}\n")


if __name__ == "__main__":
    main()
