"""Record the JAX package's results for the port's beindex and dense
engines at full size.

``chip_smoke.py`` (phase 8) runs the PyTorch port's dense and beindex
engines and the four butterfly-counting kernels on these graphs on the
card and holds them to the values written here (the card's machine has
no JAX).  Recorded:

* ``dense-16k`` — ``powerlaw_bipartite(16_384, 16_384, 400_000,
  alpha=0.6, seed=0)`` peeled as tip on side u, P=16: θ, the CD
  partition, ⋈init, ranges and ``PeelStats`` of the JAX csr engine (θ,
  partition, ranges, ⋈init and the round counts do not depend on the
  engine; ``updates`` and ``recounts`` do); the sha256 of the exact
  per-vertex and per-edge butterfly counts (what ``vertex_butterflies``
  and ``edge_wedge_matrix`` compute); with ``--with-dense`` also the
  JAX dense engine's own ``PeelStats``.
* ``wing-60k`` — the BE-Index of ``torch_fullsize.json``'s wing graph
  (sizes and the sha256 of each array) and the JAX beindex engine's θ,
  partition, ⋈init, ranges and ``PeelStats``; with ``--with-dense``
  also the JAX dense engine's.

Run from the repository root (the csr and beindex runs take about two
minutes on a CPU and a few GiB; ``--with-dense`` adds the dense
engine's 16 384² products, many minutes)::

    PYTHONPATH=src python tests/goldens/record_torch_engines.py [--with-dense]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np

from repro.core import csr
from repro.core.beindex import build_beindex
from repro.core.graph import powerlaw_bipartite
from repro.core.peel import tip_decomposition, wing_decomposition

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_engines.json")

DENSE_16K = dict(n_u=16_384, n_v=16_384, m=400_000, alpha=0.6, seed=0)
G_60K = dict(n_u=8_000, n_v=4_000, m=60_000, alpha=0.6, seed=0)
P = 16
STAT_FIELDS = ("rho_cd", "rho_fd_total", "rho_fd_max", "updates",
               "recounts", "p_effective")
BE_ARRAYS = ("bloom_k", "link_edge", "link_twin", "link_bloom")


def sha256(a, dtype=np.int64) -> str:
    """sha256 of an array's bytes in ``dtype`` (int64: the CLI's θ
    digest)."""
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(a, dtype=dtype)).tobytes()
    ).hexdigest()


def snapshot(res) -> dict:
    s = res.stats
    return dict(
        theta_sha256=sha256(res.theta),
        part_sha256=sha256(res.part),
        support_init_sha256=sha256(res.support_init),
        ranges=np.asarray(res.ranges).tolist(),
        theta_max=int(res.theta.max()) if res.theta.size else 0,
        stats={f: int(getattr(s, f)) for f in STAT_FIELDS},
    )


def record(dense_graph: dict, wing_graph: dict, with_dense: bool,
           log=print) -> dict:
    """The recording for a tip graph peeled by the dense engine and a
    wing graph peeled by the beindex (and dense) engine."""
    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"[engines] {label}: {time.perf_counter() - t0:.1f}s on the JAX "
            f"CPU backend")
        return out

    out = {}
    g = powerlaw_bipartite(**dense_graph)
    wed = csr.build_wedges(g)
    sup_u = csr.vertex_butterflies_csr(wed)
    sup_e = csr.edge_butterflies0(wed)
    du, dv = g.degrees()
    rec = dict(graph=dense_graph, kind="tip", side="u", P=P, m=g.m,
               edges_sha256=sha256(g.edges),
               max_degree=[int(du.max()), int(dv.max())],
               vertex_butterflies_sha256=sha256(sup_u),
               vertex_butterflies_max=int(sup_u.max()),
               edge_butterflies_sha256=sha256(sup_e),
               total_butterflies=int(sup_u.sum()) // 2)
    del wed, sup_u, sup_e
    res = timed("dense-16k csr", lambda: tip_decomposition(
        g, side="u", P=P, engine="csr", fd_driver="device"))
    rec["csr"] = snapshot(res)
    if with_dense:
        res = timed("dense-16k dense", lambda: tip_decomposition(
            g, side="u", P=P, engine="dense"))
        rec["dense"] = snapshot(res)
    out["dense-16k"] = rec

    g = powerlaw_bipartite(**wing_graph)
    be = timed("wing-60k build_beindex", lambda: build_beindex(g))
    rec = dict(graph=wing_graph, kind="wing", P=P, m=g.m,
               edges_sha256=sha256(g.edges),
               index=dict(
                   nb=int(be.nb), n_links=int(be.n_links),
                   max_pairs=int(be.bloom_k.max()) if be.nb else 0,
                   **{f"{k}_sha256": sha256(getattr(be, k), np.int32)
                      for k in BE_ARRAYS}))
    res = timed("wing-60k beindex", lambda: wing_decomposition(
        g, P=P, engine="beindex", be=be))
    rec["beindex"] = snapshot(res)
    if with_dense:
        res = timed("wing-60k dense", lambda: wing_decomposition(
            g, P=P, engine="dense"))
        rec["dense"] = snapshot(res)
    out["wing-60k"] = rec
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--with-dense", action="store_true",
                    help="also run the JAX dense engine on both graphs")
    args = ap.parse_args()
    out = record(DENSE_16K, G_60K, args.with_dense,
                 log=lambda msg: print(msg, flush=True))
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    print(f"[engines] wrote {OUT}")


if __name__ == "__main__":
    main()
