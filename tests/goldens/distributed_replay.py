#!/usr/bin/env python
"""Replay ``torch_distributed.json``'s cells through the port's
distributed peel (``repro_torch.core.distributed``) — on the ranks of a
process group this module spawns, or in a caller's own group.

It imports ``torch`` and ``repro_torch`` only (never ``jax`` or
``repro``), so ``tests/test_torch_distributed.py``, the ``cuda`` test
and ``chip_smoke.py`` all run it.  As a script it spawns ``--world``
gloo ranks (``file://`` rendezvous in ``--out``, no port), and every
rank replays every golden cell on each ``--mesh`` (``1d``: the
``("peel",)`` mesh; ``2d``: ``make_peel_mesh_2d``) and writes
``rank{r}.json`` (with ``--obs`` also ``1d+obs``, the 1-D mesh again
with the obs layer on): per mesh and cell what :func:`record` keeps, the
module's collective counts by phase, and the number of
``torch.distributed`` collective calls of any kind (every collective
function of the module is wrapped to count, so one issued outside
``core.distributed``'s helpers shows as a difference)::

    PYTHONPATH=src python tests/goldens/distributed_replay.py \\
        --world 4 --mesh 1d 2d --obs --out /tmp/replay

With ``--graph N_U N_V M ALPHA SEED`` it is instead one rank of the
peel CLI on that generated graph (``chip_smoke.py`` runs the 60k graph,
alpha 0.6, so on four ranks)::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tests/goldens/distributed_replay.py --graph 8000 4000 60000 0.6 0 \\
        --kind wing --engine csr --aligned --backend gloo --device cuda
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PATH = os.path.join(HERE, "torch_distributed.json")

# every torch.distributed function that talks to other ranks
COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "broadcast", "broadcast_object_list", "reduce",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "gather", "gather_object", "scatter",
    "scatter_object_list", "barrier", "monitored_barrier", "send", "recv",
    "isend", "irecv", "batch_isend_irecv",
)


def load_golden() -> dict:
    """The recorded JAX cells."""
    with open(GOLDEN_PATH) as f:
        return json.load(f)


def cell_name(cell: dict) -> str:
    """The golden key of a cell (as the recorder names it)."""
    layout = "aligned" if cell["aligned"] else "flat"
    return (f"{cell['kind']}/{cell['engine']}/{layout}/{cell['fd_driver']}"
            f"/{cell['side'] or '-'}")


def graph(spec: dict):
    """The port's copy of a recipe graph."""
    from repro_torch.core import graph as gmod

    a = spec["args"]
    return getattr(gmod, spec["gen"])(a[0], a[1], a[2], seed=a[3])


def run_cell(g, cell: dict, P: int, mesh, axis, device=None):
    """One cell through the port's entry point; returns (θ, stats,
    PeelResult)."""
    from repro_torch.core import distributed as D

    if cell["kind"] == "wing":
        return D.distributed_wing_decomposition(
            g, mesh, axis=axis, P_parts=P, engine=cell["engine"],
            aligned=cell["aligned"], device=device, return_result=True)
    return D.distributed_tip_decomposition(
        g, mesh, axis=axis, side=cell["side"], P_parts=P,
        engine=cell["engine"], aligned=cell["aligned"],
        fd_driver=cell["fd_driver"], device=device, return_result=True)


def record(theta, stats: dict, res) -> dict:
    """What the golden holds of a run: θ, part, ranges, ⋈init, the
    stats without ``n_dev`` and ``timeline``, and the timeline summary
    (None with the obs layer off)."""
    import numpy as np

    stats = dict(stats)
    stats.pop("n_dev")
    timeline = stats.pop("timeline", None)
    return dict(theta=np.asarray(theta).tolist(),
                part=np.asarray(res.part).tolist(),
                ranges=np.asarray(res.ranges).tolist(),
                support_init=np.asarray(res.support_init).tolist(),
                stats=stats, timeline=timeline)


class CountedCollectives:
    """Wraps every function of :data:`COLLECTIVES` in
    ``torch.distributed`` to count its calls while the block runs."""

    def __enter__(self):
        import torch.distributed as dist

        self.calls = 0
        self.saved = {}
        for name in COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self.saved[name] = fn

            def counted(*a, _fn=fn, **k):
                self.calls += 1
                return _fn(*a, **k)

            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self.saved.items():
            setattr(dist, name, fn)


def replay(golden: dict, mesh, axis, device=None) -> dict:
    """Every golden cell on ``mesh``: :func:`record` plus ``counts`` (the
    module's, by phase) and ``calls`` (every collective call)."""
    from repro_torch.core import distributed as D

    out = {}
    for gname, spec in golden["graphs"].items():
        g = graph(spec)
        for cell in golden["cells"]:
            D.reset_collective_counts()
            with CountedCollectives() as cc:
                theta, stats, res = run_cell(g, cell, spec["P"], mesh,
                                             axis, device)
            rec = record(theta, stats, res)
            rec.update(counts=D.collective_counts(), calls=cc.calls,
                       n_dev=stats["n_dev"])
            out[f"{gname}:{cell_name(cell)}"] = rec
    return out


def _rank_main(rank: int, world: int, out_dir: str, meshes, obs_on: bool,
               device: str) -> None:
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.launch.mesh import make_peel_mesh, make_peel_mesh_2d

    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'rdzv')}",
        rank=rank, world_size=world)
    try:
        golden = load_golden()
        result = {}
        for kind in meshes:
            if kind == "1d":
                mesh, axis = make_peel_mesh(device=device), "peel"
            else:
                mesh, axis = make_peel_mesh_2d(device=device), ("grp", "loc")
            result[kind] = dict(shape=list(mesh.mesh.shape),
                                cells=replay(golden, mesh, axis))
            if obs_on and kind == "1d":
                obs.enable()
                try:
                    result["1d+obs"] = dict(shape=list(mesh.mesh.shape),
                                            cells=replay(golden, mesh, axis))
                finally:
                    obs.disable()
        result["jax_imported"] = any(
            m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
            for m in sys.modules)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def peel_graph(graph_args, cli_argv) -> int:
    """One rank of ``repro_torch.launch.peel`` on a generated graph:
    ``powerlaw_bipartite(n_u, n_v, m, alpha, seed)`` (the CLI itself
    generates only its default skew), through the CLI's ``run`` with
    ``cli_argv``; run it under ``python -m torch.distributed.run``."""
    import torch.distributed as dist

    from repro_torch.core.graph import powerlaw_bipartite
    from repro_torch.launch import peel as cli

    n_u, n_v, m, alpha, seed = graph_args
    g = powerlaw_bipartite(int(n_u), int(n_v), int(m), alpha=float(alpha),
                           seed=int(seed))
    try:
        cli.run(cli.build_parser().parse_args(cli_argv), g=g)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    """Spawn ``--world`` gloo ranks that replay every cell; or, with
    ``--graph N_U N_V M ALPHA SEED`` first, be one rank of the CLI on
    that graph (every argument after those five is the CLI's)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--graph"]:
        return peel_graph(argv[1:6], argv[6:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--mesh", nargs="+", default=["1d"],
                    choices=["1d", "2d"])
    ap.add_argument("--obs", action="store_true",
                    help="replay the 1d mesh a second time with the obs "
                         "layer on (key '1d+obs': the timelines)")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--out", required=True, help="directory for rank*.json")
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp

    os.makedirs(args.out, exist_ok=True)
    mp.start_processes(
        _rank_main, args=(args.world, args.out, args.mesh, args.obs,
                          args.device),
        nprocs=args.world, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
