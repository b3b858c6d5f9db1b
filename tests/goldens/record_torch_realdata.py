"""Record the JAX package's results on the real-graph path: edge-list
ingest, tiled ⋈init, peel, hierarchy and served queries.

``chip_smoke.py`` runs the PyTorch port's ``--edges ... --emit-hierarchy``
path on the card and holds every step to the values written here (the
card's machine has no JAX).  Each graph's edge list is written to a
TSV — a ``%`` header line, then 1-based ``u<TAB>v`` rows — whose sha256
is recorded, so the smoke run can check that it ingests the same
bytes.  Recorded per run:

* the ingest: ``n_u``/``n_v``/``m`` and the sha256 of each CSR file;
* the tiled ⋈init on the host path (``tile_wedges`` 2^20): the sha256
  of ``sup_e``/``sup_u``, the total and the ``TileStats`` counts;
* θ, the CD partition, ⋈init, ranges and the ``PeelStats`` counts
  (unfused ``device`` FD driver; every csr driver gives the same);
* the hierarchy: node and level counts and the sha256 of each artifact
  array and of the pack cache (``pack_depth``/``pack_up``);
* the sha256 of the answers to :func:`query_batch_inputs`' seeded
  batch of mixed ``HierarchyService`` queries.

Run from the repository root (about four minutes on a CPU, a few GiB)::

    PYTHONPATH=src python tests/goldens/record_torch_realdata.py
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time

import numpy as np

from repro.core import csr
from repro.core.graph import powerlaw_bipartite
from repro.core.peel import tip_decomposition, wing_decomposition
from repro.data import ingest_edges
from repro.hierarchy import HierarchyService, build_hierarchy
from repro.hierarchy.query import depth_and_up
from repro.hierarchy.serialize import _ARRAY_FIELDS

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_realdata.json")
SOUTHERN_WOMEN = os.path.join(HERE, "..", "..", "datasets",
                              "southern_women.tsv")

TIP_1M = dict(n_u=100_000, n_v=50_000, m=1_000_000, alpha=0.6, seed=0)
G_60K = dict(n_u=8_000, n_v=4_000, m=60_000, alpha=0.6, seed=0)
# run name -> (graph recipe, or None for southern_women; kind)
RUNS = {
    "tip-1m": (TIP_1M, "tip"),
    "wing-60k": (G_60K, "wing"),
    "tip-60k": (G_60K, "tip"),
    "southern_women-wing": (None, "wing"),
    "southern_women-tip": (None, "tip"),
}
P = 16
TILE_WEDGES = 1 << 20
N_QUERIES = 4096
STAT_FIELDS = ("rho_cd", "rho_fd_total", "rho_fd_max", "updates",
               "recounts", "p_effective")
INGEST_FILES = ("edges", "off_u", "off_v", "nbr_v", "eid_v")


def sha_bytes(a) -> str:
    """sha256 of an array's raw bytes in its own dtype."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def sha_int64(a) -> str:
    """sha256 of an array's int64 bytes (the CLI's ``theta`` digest)."""
    return sha_bytes(np.asarray(a, dtype=np.int64))


def write_tsv(path: str, edges) -> None:
    """The edge list as a KONECT-style TSV: a header, 1-based rows."""
    with open(path, "w") as f:
        f.write("% bip unweighted\n")
        np.savetxt(f, np.asarray(edges, dtype=np.int64) + 1, fmt="%d",
                   delimiter="\t")


def query_batch_inputs(n_entities: int, n_nodes: int, n: int = N_QUERIES,
                       seed: int = 0):
    """A seeded batch of mixed queries: op codes 0..4 of
    ``HierarchyService``'s ``OPS``, entity ids (node ids for op 4,
    ``subtree_size``) and second entity ids."""
    rng = np.random.default_rng(seed)
    ops = rng.integers(0, 5, size=n)
    a_ent = rng.integers(0, n_entities, size=n)
    a_node = rng.integers(0, n_nodes, size=n)
    b = rng.integers(0, n_entities, size=n)
    a = np.where(ops == 4, a_node, a_ent)
    return ops.astype(np.int32), a.astype(np.int32), b.astype(np.int32)


def record(name, recipe, kind, td) -> dict:
    t0 = time.perf_counter()
    if recipe is None:
        tsv = SOUTHERN_WOMEN
    else:
        tsv = os.path.join(td, f"{name}.tsv")
        write_tsv(tsv, powerlaw_bipartite(**recipe).edges)
    with open(tsv, "rb") as f:
        tsv_sha = hashlib.sha256(f.read()).hexdigest()
    ig = ingest_edges(tsv, out_dir=os.path.join(td, f"{name}.ingest"))
    ingest = dict(n_u=ig.n_u, n_v=ig.n_v, m=ig.m)
    for key in INGEST_FILES:
        ingest[f"{key}_sha256"] = sha_bytes(getattr(ig, key))
    sup_e, sup_u, total, ts = csr.tiled_butterfly_init(
        ig, tile_wedges=TILE_WEDGES)
    tiled = dict(sup_e_sha256=sha_int64(sup_e), sup_u_sha256=sha_int64(sup_u),
                 total=int(total), n_tiles=ts.n_tiles, n_wedges=ts.n_wedges,
                 n_pairs=ts.n_pairs, peak_tile_wedges=ts.peak_tile_wedges)
    t1 = time.perf_counter()
    g = ig.as_graph()
    if kind == "tip":
        res = tip_decomposition(g, side="u", P=P, engine="csr",
                                fd_driver="device", sup0=sup_u)
    else:
        res = wing_decomposition(g, P=P, engine="csr", fd_driver="device",
                                 sup0=sup_e)
    t2 = time.perf_counter()
    h = build_hierarchy(g, res, kind=kind, side="u")
    t3 = time.perf_counter()
    depth, up = depth_and_up(np.asarray(h.parent))
    hier = dict(n_nodes=h.n_nodes, n_levels=int(h.levels.size),
                arrays={f: sha_bytes(getattr(h, f)) for f in _ARRAY_FIELDS},
                pack_depth_sha256=sha_bytes(depth),
                pack_up_sha256=sha_bytes(up))
    ops, a, b = query_batch_inputs(h.n_entities, h.n_nodes)
    answers = HierarchyService(h).query_batch(ops, a, b)
    s = res.stats
    out = dict(
        graph=recipe, kind=kind, side="u", P=P, tile_wedges=TILE_WEDGES,
        tsv_sha256=tsv_sha, ingest=ingest, tiled_init=tiled,
        theta_sha256=sha_int64(res.theta), part_sha256=sha_int64(res.part),
        support_init_sha256=sha_int64(res.support_init),
        ranges=np.asarray(res.ranges).tolist(),
        stats={f: int(getattr(s, f)) for f in STAT_FIELDS},
        hierarchy=hier,
        queries=dict(n=N_QUERIES, seed=0,
                     answers_sha256=sha_int64(answers)),
    )
    print(f"[realdata] {name}: ingest+tiled {t1 - t0:.1f}s, peel "
          f"{t2 - t1:.1f}s, hierarchy {t3 - t2:.1f}s on the JAX CPU "
          f"backend; |U|={ig.n_u} |V|={ig.n_v} |E|={ig.m} "
          f"tiles={ts.n_tiles} nodes={h.n_nodes} levels={hier['n_levels']}",
          flush=True)
    return out


def main() -> None:
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for name, (recipe, kind) in RUNS.items():
            out[name] = record(name, recipe, kind, td)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"[realdata] wrote {OUT}")


if __name__ == "__main__":
    main()
