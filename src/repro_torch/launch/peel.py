"""Single-device peeling CLI of the PyTorch port.

The same flags as the JAX package's ``python -m repro.launch.peel`` for
``--kind/--engine/--fd-driver/--fused-fd/--use-pallas/--parts/--dataset/
--edges/--tile-wedges/--ingest-dir/--n-u/--n-v/--m/--seed/--side/--out/
--emit-hierarchy/--trace``, plus ``--device`` (default ``cuda``; ``cpu``
runs the plain versions of the kernels).  It prints the same ``[peel]
theta: ... sha256=...`` line, so a run of each CLI on the same flags can
be compared digest for digest::

    PYTHONPATH=src python -m repro_torch.launch.peel --kind wing
    PYTHONPATH=src python -m repro_torch.launch.peel --kind tip --engine dense
    PYTHONPATH=src python -m repro_torch.launch.peel --kind tip \
        --edges datasets/southern_women.tsv --emit-hierarchy sw_tip.npz

The engine defaults as the JAX CLI's: ``beindex`` for ``--kind wing``,
``csr`` for ``--kind tip`` and for every ``--edges`` run; ``--engine
dense`` runs for both kinds.  ``--edges`` is the real-graph path:
out-of-core ingest, the tiled ⋈init (through the ``wedge_count_tile``
kernel with ``--use-pallas``), then the engines fed through ``sup0``.
``--emit-hierarchy`` builds the hierarchy on the device and writes the
versioned npz artifact.  ``--trace PATH`` turns the observability
layer (``repro_torch.obs``) on for the run, prints the ``[peel]
timeline:`` digest and writes a Chrome trace of the peel / cd /
cd.round / fd / fd.launch / fd.round / hierarchy events to PATH.
Unsupported flag combinations exit with the JAX CLI's error texts.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time


class LaunchError(SystemExit):
    """Unsupported flag combination — raised instead of silently
    falling back to a different engine/driver."""

    def __init__(self, msg: str):
        super().__init__(f"[peel] error: {msg}")


def _validate(args) -> None:
    """Resolve the per-kind engine and fused-FD defaults as the JAX CLI
    does for one device, then reject unsupported combinations."""
    if args.engine is None:
        # real graphs default to csr, the engine whose memory is
        # wedge-bounded like the tiled ⋈init they arrive through
        if args.edges:
            args.engine = "csr"
        else:
            args.engine = "beindex" if args.kind == "wing" else "csr"
    if args.edges and args.dataset:
        raise LaunchError(
            "--edges and --dataset are exclusive graph sources")
    if args.kind == "tip" and args.engine == "beindex":
        raise LaunchError(
            "tip peels vertices — there is no BE-Index tip engine; "
            "pass --engine csr (scalable) or --engine dense")
    if args.use_pallas and args.engine != "csr":
        raise LaunchError(
            "--use-pallas routes csr slot layouts through the blocked "
            "kernels; pass --engine csr")
    if args.fd_driver == "vmapped" and args.engine != "csr":
        raise LaunchError(
            "--fd-driver vmapped is the csr single-dispatch Phase 2; "
            "pass --engine csr")
    if args.fused_fd and args.engine != "csr":
        raise LaunchError(
            "--fused-fd is the fused csr FD round kernel; pass "
            "--engine csr")
    if args.fused_fd and args.fd_driver == "host":
        raise LaunchError(
            "--fused-fd fuses the device-side FD round; the host driver "
            "has no device round body (pass --fd-driver device|vmapped)")
    if args.fused_fd is None:
        # on where supported: the csr engine with a device-side FD driver
        args.fused_fd = (args.engine == "csr"
                         and args.fd_driver in ("device", "vmapped"))


def sha256_int64(a) -> str:
    """sha256 of an array's int64 bytes — the CLI's θ digest."""
    import numpy as np

    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(a, dtype=np.int64)).tobytes()
    ).hexdigest()


def _ingest(args, seconds: dict):
    """The ``--edges`` front half: ingest out of core, then the tiled
    ⋈init.  Returns (graph, sup0, tiled-init summary) and fills
    ``seconds``."""
    from types import SimpleNamespace

    from ..core import csr
    from ..data import ingest_edges

    t0 = time.perf_counter()
    ig = ingest_edges(args.edges, out_dir=args.ingest_dir)
    print(f"[peel] ingested {args.edges}: |U|={ig.n_u} "
          f"|V|={ig.n_v} |E|={ig.m}")
    t1 = time.perf_counter()
    if args.kind == "tip" and args.side == "v":
        # wedge centers must sit on the peeled side's opposite
        # partition: transpose the CSR view, not the data
        src = SimpleNamespace(n_u=ig.n_v, n_v=ig.n_u, m=ig.m,
                              csr_v=ig.csr_u)
    else:
        src = ig
    sup_e, sup_u, total_bf, tstats = csr.tiled_butterfly_init(
        src, tile_wedges=args.tile_wedges, use_pallas=args.use_pallas,
        device=args.device)
    print(f"[peel] tiled init: butterflies={total_bf} "
          f"tiles={tstats.n_tiles} wedges={tstats.n_wedges} "
          f"peak_tile_wedges={tstats.peak_tile_wedges}")
    seconds.update(ingest=t1 - t0, tiled_init=time.perf_counter() - t1)
    sup0 = sup_e if args.kind == "wing" else sup_u
    return ig.as_graph(), sup0, dict(butterflies=total_bf, stats=tstats,
                                     sup0=sup0)


def _emit_hierarchy(args, g, result, seconds: dict):
    """Build the dense-subgraph hierarchy from the decomposition on the
    device and write the versioned artifact; returns the Hierarchy."""
    import numpy as np

    from ..hierarchy import (build_hierarchy, density_profile,
                             save_hierarchy, top_densest_leaves)

    timings: dict = {}
    t0 = time.perf_counter()
    h = build_hierarchy(g, result, kind=args.kind, side=args.side,
                        device=args.device, timings=timings)
    dt = time.perf_counter() - t0
    save_hierarchy(args.emit_hierarchy, h)
    seconds.update(hierarchy_labels=timings["labels"],
                   hierarchy_incidence=timings.get("incidence", 0.0),
                   hierarchy_assembly=timings["assembly"])
    lv = h.levels
    print(f"[peel] hierarchy: {h.n_nodes} nodes over {lv.size} levels "
          f"built in {dt * 1e3:.1f} ms (labels {timings['labels']:.3f} s "
          f"in {timings.get('iterations', 0)} iterations, assembly "
          f"{timings['assembly']:.3f} s) -> {args.emit_hierarchy}")
    if lv.size:
        prof = density_profile(h, int(lv[0]))
        top = top_densest_leaves(h, 3)
        print(f"[peel] k={int(lv[0])}: {prof['n_components']} components; "
              f"densest leaves: "
              f"{np.round(top['density'], 3).tolist()} "
              f"at k={top['level'].tolist()}")
    return h


def run(args, g=None) -> dict:
    """Peel ``g`` (default: the graph the flags describe) and print the
    JAX CLI's summary lines.  Returns the stats row with
    ``theta_sha256``; ``stats_out["result"]`` holds the PeelResult,
    ``stats_out["seconds"]`` the seconds of each step (``ingest``,
    ``tiled_init``, ``peel`` — of which ``cd`` and ``fd`` are the two
    phases, the rest the engine's setup —, ``hierarchy_labels`` — of which
    ``hierarchy_incidence`` is the host wedge enumeration —,
    ``hierarchy_assembly``, as far as the run had them), with
    ``--edges`` ``stats_out["tiled_init"]`` the tiled init's total
    butterflies, TileStats and ⋈init vector, with ``--emit-hierarchy``
    ``stats_out["hierarchy"]`` the Hierarchy, and with ``--trace``
    ``stats_out["timeline"]`` the timeline's digest and
    ``stats_out["trace"]`` the Tracer (the layer is off again after the
    run unless the caller had turned it on)."""
    from .. import obs

    _validate(args)
    was_on = obs.enabled()
    if args.trace:
        obs.enable()
    try:
        stats_out = _run(args, g)
    finally:
        tracer = obs.get_tracer()
        if args.trace and not was_on:
            obs.disable()
    if args.trace:
        tracer.save(args.trace)
        stats_out["trace"] = tracer
        print(f"[peel] trace: {len(tracer.events)} events -> {args.trace}")
    return stats_out


def _run(args, g) -> dict:
    from ..core.graph import paper_proxy_dataset, powerlaw_bipartite
    from ..core.peel import tip_decomposition, wing_decomposition

    seconds: dict = {}
    sup0 = tiled = None
    if args.edges:
        g, sup0, tiled = _ingest(args, seconds)
    elif g is None:
        if args.dataset:
            g = paper_proxy_dataset(args.dataset)
        else:
            g = powerlaw_bipartite(args.n_u, args.n_v, args.m, seed=args.seed)
    print(f"[peel] graph |U|={g.n_u} |V|={g.n_v} |E|={g.m}")

    common = dict(P=args.parts, engine=args.engine, fd_driver=args.fd_driver,
                  use_pallas=args.use_pallas, fused=args.fused_fd,
                  sup0=sup0, device=args.device)
    t0 = time.perf_counter()
    if args.kind == "wing":
        res = wing_decomposition(g, **common)
        s = res.stats
        print(f"[peel] engine={s.engine} rho_cd={s.rho_cd} "
              f"rho_fd_max={s.rho_fd_max} updates={s.updates} "
              f"sync_reduction={s.sync_reduction:.1f}x")
    else:
        res = tip_decomposition(g, side=args.side, **common)
        s = res.stats
        print(f"[peel] engine={s.engine} side={s.side} "
              f"rho_cd={s.rho_cd} rho_fd_max={s.rho_fd_max} "
              f"recounts={s.recounts}")
    seconds["peel"] = time.perf_counter() - t0
    seconds.update(res.seconds)
    theta = res.theta
    stats_out = s.as_dict()
    if res.timeline is not None:
        stats_out["timeline"] = res.timeline.summary()
        print(f"[peel] timeline: {stats_out['timeline']}")
    stats_out["theta_sha256"] = sha256_int64(theta)
    print(f"[peel] theta: max={int(theta.max()) if theta.size else 0} "
          f"levels={len(set(theta.tolist()))} "
          f"sha256={stats_out['theta_sha256']}")
    h = (_emit_hierarchy(args, g, res, seconds) if args.emit_hierarchy
         else None)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(theta=theta.tolist(), stats=stats_out), f)
    stats_out["result"] = res
    stats_out["seconds"] = seconds
    if tiled is not None:
        stats_out["tiled_init"] = tiled
    if h is not None:
        stats_out["hierarchy"] = h
    return stats_out


def build_parser() -> argparse.ArgumentParser:
    """The CLI's argument parser."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.peel",
        description="PBNG tip/wing decomposition (PyTorch port, single "
                    "device)")
    ap.add_argument("--kind", "--mode", dest="kind",
                    choices=["wing", "tip"], default="wing",
                    help="entity universe to peel: edges (wing) or "
                         "vertices (tip)")
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--edges", default=None, metavar="PATH",
                    help="peel a real graph: KONECT/SNAP-style edge list "
                         "(%% or # comments, 1- or 0-based ids, negative "
                         "third column = deletion), ingested out of core "
                         "and counted in bounded wedge tiles "
                         "(--tile-wedges); exclusive with --dataset")
    ap.add_argument("--tile-wedges", type=int, default=1 << 20,
                    help="wedge-tile budget of the --edges counting pass "
                         "(default 2^20)")
    ap.add_argument("--ingest-dir", default=None, metavar="DIR",
                    help="cache directory of the --edges ingest (default: "
                         "<edges>.ingest next to the input)")
    ap.add_argument("--n-u", type=int, default=400)
    ap.add_argument("--n-v", type=int, default=200)
    ap.add_argument("--m", type=int, default=2000)
    ap.add_argument("--parts", type=int, default=16)
    ap.add_argument("--engine", default=None,
                    choices=["beindex", "dense", "csr"],
                    help="peeling engine; default as the JAX CLI: "
                         "beindex for wing, csr for tip and for --edges")
    ap.add_argument("--fd-driver", default="device",
                    choices=["device", "vmapped", "host"],
                    help="FD driver: per partition in LPT order (device), "
                         "all partitions in one batched loop (vmapped), "
                         "or per-round host loop (host)")
    ap.add_argument("--fused-fd", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="run every FD round as one fused kernel call "
                         "(fd_round_wing / fd_round_tip); default: on for "
                         "the device and vmapped drivers")
    ap.add_argument("--use-pallas", action="store_true",
                    help="run CD updates through the support_update / "
                         "wedge_count kernels (and, for wing "
                         "--fd-driver vmapped --no-fused-fd, the FD "
                         "updates), and the --edges tiled init through "
                         "wedge_count_tile; the JAX CLI's flag name")
    ap.add_argument("--side", default="u")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--emit-hierarchy", default=None, metavar="PATH",
                    help="build the dense-subgraph hierarchy from the "
                         "decomposition and save it as a versioned npz "
                         "artifact (repro_torch.hierarchy.load_hierarchy; "
                         "the JAX package loads it too)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="turn the observability layer on and write a "
                         "Chrome-trace JSON of the run (open in Perfetto "
                         "/ chrome://tracing): peel/cd/fd spans, per-round "
                         "cd.round/fd.round events, hierarchy build "
                         "spans.  Off by default, and off changes nothing")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    return ap


def main(argv=None) -> int:
    """Parse ``argv`` and run."""
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
