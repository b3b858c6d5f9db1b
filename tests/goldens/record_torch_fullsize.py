"""Record the JAX package's results on the two full-size csr graphs.

``chip_smoke.py`` runs the PyTorch port on these graphs on the card and
holds θ and the ``PeelStats`` fields to the values written here.  The
card's machine has no JAX, so the reference values are recorded once
on a CPU with the JAX package (unfused ``device`` FD driver — every csr
driver gives the same θ and counts; the golden tests lock that)::

    PYTHONPATH=src python tests/goldens/record_torch_fullsize.py

tip-1m takes about a minute and a few GiB of host memory, the others
seconds.
"""
from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np

from repro.core.graph import powerlaw_bipartite
from repro.core.peel import tip_decomposition, wing_decomposition

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_fullsize.json")

# name -> (graph recipe kwargs, kind, P); chip_smoke.py reads the recipe
# back from the JSON (``graph``), so the two cannot drift apart
GRAPHS = {
    "tip-1m": (dict(n_u=100_000, n_v=50_000, m=1_000_000, alpha=0.6,
                    seed=0), "tip", 16),
    "wing-60k": (dict(n_u=8_000, n_v=4_000, m=60_000, alpha=0.6, seed=0),
                 "wing", 16),
    # the wing-60k graph peeled as tip: the graph whose vertex-major
    # tip slots are small enough for the wedge_count kernel route
    "tip-60k": (dict(n_u=8_000, n_v=4_000, m=60_000, alpha=0.6, seed=0),
                "tip", 16),
}

STAT_FIELDS = ("rho_cd", "rho_fd_total", "rho_fd_max", "updates",
               "recounts", "p_effective")


def sha256(a) -> str:
    """sha256 of an array's int64 bytes (the CLI's ``theta`` digest)."""
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(a, dtype=np.int64)).tobytes()
    ).hexdigest()


def main() -> None:
    out = {}
    for name, (kw, kind, P) in GRAPHS.items():
        g = powerlaw_bipartite(**kw)
        t0 = time.perf_counter()
        if kind == "tip":
            res = tip_decomposition(g, side="u", P=P, engine="csr",
                                    fd_driver="device")
        else:
            res = wing_decomposition(g, P=P, engine="csr",
                                     fd_driver="device")
        dt = time.perf_counter() - t0
        s = res.stats
        out[name] = dict(
            graph=kw, kind=kind, P=P, m=g.m,
            edges_sha256=sha256(g.edges),
            theta_sha256=sha256(res.theta),
            part_sha256=sha256(res.part),
            support_init_sha256=sha256(res.support_init),
            ranges=np.asarray(res.ranges).tolist(),
            theta_max=int(res.theta.max()) if res.theta.size else 0,
            stats={f: int(getattr(s, f)) for f in STAT_FIELDS},
        )
        print(f"[fullsize] {name}: {dt:.1f}s on the JAX CPU backend "
              f"{out[name]['stats']}")
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    print(f"[fullsize] wrote {OUT}")


if __name__ == "__main__":
    main()
