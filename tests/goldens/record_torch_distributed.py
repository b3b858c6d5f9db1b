#!/usr/bin/env python
"""Record the JAX package's distributed peel (``torch_distributed.json``):
the golden that ``tests/test_torch_distributed.py``, the ``cuda`` test
and ``chip_smoke.py``'s distributed phase hold the port's
``repro_torch.core.distributed`` and ``launch.peel`` to.

JAX runs on 8 forced host devices (``--xla_force_host_platform_device_count``,
as ``tests/test_core_distributed.py`` does), a 1-D ``("peel",)`` mesh.
The recipe is stored beside what it produced:

* ``graphs`` — the small graphs of ``tests/test_core_distributed.py``
  (``random_bipartite`` / ``powerlaw_bipartite`` arguments and P), and
  ``tiny``, which has fewer U-pairs and U vertices than 8 ranks, so
  some shards of the aligned layouts hold nothing but padding;
* ``cells`` — every (kind, engine, layout, fd_driver, side) the entry
  points admit: wing beindex and csr, each flat and aligned; tip csr
  flat and vertex-aligned, each with the ``device`` and ``vmapped`` FD
  drivers, and tip dense, on both sides.

Recorded per graph and cell, with the obs layer on: θ, ``part``,
``ranges``, ``support_init``, the stats dict without ``n_dev`` and
``timeline``, and the timeline's summary.  Then ``python -m
repro.launch.peel`` on the same 8 devices over the CLI's default graph
(``cli``: the flags, and the ``--out`` file's θ and stats).

    PYTHONPATH=src JAX_PLATFORMS=cpu \
        python tests/goldens/record_torch_distributed.py

(about a minute on a CPU.)
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

N_DEV = 8
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={N_DEV} "
    + os.environ.get("XLA_FLAGS", ""))

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
GOLDEN_PATH = os.path.join(HERE, "torch_distributed.json")

GRAPHS = {
    "rb16-s0": dict(gen="random_bipartite", args=[16, 12, 48, 0], P=4),
    "rb16-s1": dict(gen="random_bipartite", args=[16, 12, 48, 1], P=4),
    "pl100": dict(gen="powerlaw_bipartite", args=[100, 50, 420, 5], P=6),
    "pl60": dict(gen="powerlaw_bipartite", args=[60, 40, 260, 7], P=4),
    "tiny": dict(gen="random_bipartite", args=[4, 5, 12, 0], P=4),
}
CELLS = (
    [dict(kind="wing", engine=e, aligned=a, fd_driver="device", side="")
     for e in ("beindex", "csr") for a in (False, True)]
    + [dict(kind="tip", engine="csr", aligned=a, fd_driver=d, side=s)
       for s in ("u", "v") for a in (False, True)
       for d in ("device", "vmapped")]
    + [dict(kind="tip", engine="dense", aligned=False, fd_driver="device",
            side=s) for s in ("u", "v")]
)
CLI = [
    ["--kind", "wing"],
    ["--kind", "wing", "--engine", "csr", "--aligned"],
    ["--kind", "tip", "--aligned"],
]


def cell_name(cell: dict) -> str:
    """The golden key of a cell: kind/engine/layout/fd_driver/side."""
    layout = "aligned" if cell["aligned"] else "flat"
    return (f"{cell['kind']}/{cell['engine']}/{layout}/{cell['fd_driver']}"
            f"/{cell['side'] or '-'}")


def _graph(spec):
    from repro.core import graph

    a = spec["args"]
    return getattr(graph, spec["gen"])(a[0], a[1], a[2], seed=a[3])


def _run_cell(g, cell, P, mesh):
    from repro.core import distributed as D

    if cell["kind"] == "wing":
        return D.distributed_wing_decomposition(
            g, mesh, P_parts=P, engine=cell["engine"],
            aligned=cell["aligned"], return_result=True)
    return D.distributed_tip_decomposition(
        g, mesh, side=cell["side"], P_parts=P, engine=cell["engine"],
        aligned=cell["aligned"], fd_driver=cell["fd_driver"],
        return_result=True)


def record_cells() -> dict:
    """Every (graph, cell) of the recipe through the JAX entry points."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro import obs

    mesh = Mesh(np.array(jax.devices()).reshape(N_DEV), ("peel",))
    out: dict = {}
    obs.enable()
    try:
        for gname, spec in GRAPHS.items():
            g = _graph(spec)
            for cell in CELLS:
                theta, stats, res = _run_cell(g, cell, spec["P"], mesh)
                assert stats["n_dev"] == N_DEV
                timeline = stats.pop("timeline")
                stats.pop("n_dev")
                out[f"{gname}:{cell_name(cell)}"] = dict(
                    theta=np.asarray(theta).tolist(),
                    part=np.asarray(res.part).tolist(),
                    ranges=np.asarray(res.ranges).tolist(),
                    support_init=np.asarray(res.support_init).tolist(),
                    stats=stats, timeline=timeline)
    finally:
        obs.disable()
    return out


def record_cli() -> list:
    """``python -m repro.launch.peel`` on the 8 devices, each CLI flag
    set: its ``--out`` file's θ and stats."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for flags in CLI:
            path = os.path.join(tmp, "out.json")
            subprocess.run(
                [sys.executable, "-m", "repro.launch.peel", *flags,
                 "--out", path], env=env, check=True, capture_output=True)
            with open(path) as f:
                got = json.load(f)
            rows.append(dict(flags=flags, theta=got["theta"],
                             stats=got["stats"]))
    return rows


def main() -> None:
    golden = dict(n_dev=N_DEV, graphs=GRAPHS, cells=CELLS,
                  results=record_cells(), cli=record_cli())
    with open(GOLDEN_PATH, "w") as f:
        json.dump(golden, f, separators=(",", ":"))
    print(f"wrote {len(golden['results'])} cells and {len(CLI)} CLI runs "
          f"to {GOLDEN_PATH}")


if __name__ == "__main__":
    main()
