"""Peeling CLI of the PyTorch port: one device, or the ranks of a
``torch.distributed`` job.

The same flags as the JAX package's ``python -m repro.launch.peel`` for
``--kind/--engine/--fd-driver/--fused-fd/--use-pallas/--parts/--dataset/
--edges/--tile-wedges/--ingest-dir/--n-u/--n-v/--m/--seed/--side/--out/
--emit-hierarchy/--trace/--aligned/--dryrun``, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain versions of the kernels) and
``--backend`` (the process group's, for a distributed run).  It prints
the same ``[peel] theta: ... sha256=...`` line, so a run of each CLI on
the same flags can be compared digest for digest::

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

Under ``python -m torch.distributed.run`` with more than one rank
(``WORLD_SIZE`` > 1, where the JAX CLI sees more than one device) the
peel is distributed (``core.distributed``) over a 1-D ``("peel",)``
mesh: ``--backend`` defaults to ``nccl`` on ``--device cuda`` (one rank
a card) and ``gloo`` on ``--device cpu``; ``--backend gloo --device
cuda`` runs several ranks on one card.  ``--aligned`` (alias
``--pair-aligned``) takes the one-reduction CD layouts.  Rank 0 alone
prints, writes ``--out``, ``--emit-hierarchy`` and ``--trace``::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.peel --device cpu --kind tip --aligned

``--dryrun`` checks the distributed structure in one process on a
512-rank fake process group (no card, no data moves): see
:func:`_dryrun`.  Unsupported flag combinations exit with the JAX CLI's
error texts.
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


def _world_size() -> int:
    """Ranks of the job (``torchrun``'s ``WORLD_SIZE``; 1 without it)."""
    import os

    return int(os.environ.get("WORLD_SIZE", "1"))


def _validate(args, n_dev: int) -> None:
    """Resolve the per-kind engine and fused-FD defaults as the JAX CLI
    does for ``n_dev`` devices, then reject unsupported combinations."""
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
    if args.edges and n_dev > 1:
        raise LaunchError(
            "--edges feeds the tiled ⋈init into the single-device "
            "engines; the distributed CD/FD paths take proxy graphs "
            "(run single-device, or --dryrun for mesh checks)")
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
    if args.aligned and args.engine not in ("csr", "beindex"):
        raise LaunchError(
            "--aligned is the one-psum CD sharding (csr: pair/vertex "
            "aligned; beindex: bloom aligned); --engine dense has no "
            "sharded index to align")
    if args.fused_fd and args.engine != "csr":
        raise LaunchError(
            "--fused-fd is the fused csr FD round kernel; pass "
            "--engine csr")
    if args.fused_fd and args.fd_driver == "host":
        raise LaunchError(
            "--fused-fd fuses the device-side FD round; the host driver "
            "has no device round body (pass --fd-driver device|vmapped)")
    if n_dev > 1:
        if args.fused_fd:
            raise LaunchError(
                "--fused-fd is wired for the single-device csr FD "
                "drivers; distributed FD runs per-partition while_loops "
                "under shard_map")
        if args.kind == "wing" and args.engine == "dense":
            raise LaunchError(
                "no distributed dense wing path; pass --engine "
                "beindex|csr (or run single-device)")
        if args.kind == "wing" and args.fd_driver == "vmapped":
            raise LaunchError(
                "distributed wing FD runs one while_loop per partition "
                "under shard_map (driver 'device'); the single-dispatch "
                "vmapped Phase 2 is single-device wing or distributed "
                "tip only")
        if args.fd_driver == "host":
            raise LaunchError(
                "--fd-driver host is the single-device A/B baseline; "
                "the distributed FD drivers are device|vmapped")
        if args.use_pallas:
            raise LaunchError(
                "--use-pallas is wired for the single-device csr "
                "engines; the distributed CD rounds use segment_sum "
                "shards")
    elif args.aligned:
        raise LaunchError(
            "--aligned shards the CD index across devices; it needs "
            "a multi-device mesh (or use --dryrun)")
    if args.fused_fd is None:
        # on where supported: one device, the csr engine with a
        # device-side FD driver
        args.fused_fd = (n_dev == 1 and args.engine == "csr"
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
    JAX CLI's summary lines — on every rank of the job when
    ``WORLD_SIZE`` > 1 (the process group opened here unless the caller
    opened one; rank 0 alone prints and writes files).  Returns the stats row with
    ``theta_sha256``; ``stats_out["result"]`` holds the PeelResult,
    ``stats_out["seconds"]`` the seconds of each step (``ingest``,
    ``tiled_init``, ``peel`` — of which ``cd`` and ``fd`` are the two
    phases (``fd.pack`` inside ``fd``) and the rest the engine's setup
    (``spec.wedges``, ``spec.supports``, ``spec.beindex``,
    ``spec.upload``) —, ``peel.summary`` (the θ digest and the summary
    lines), ``hierarchy_labels`` — of which
    ``hierarchy_incidence`` is the host wedge enumeration —,
    ``hierarchy_assembly``, as far as the run had them; ``graph``, the
    seconds ``BipartiteGraph.from_edges`` took to build the peeled graph,
    wherever it was built (0 for a graph built otherwise); ``run``, the
    whole of this call; ``gc``, the cyclic GC's pauses inside it), with
    ``--edges`` ``stats_out["tiled_init"]`` the tiled init's total
    butterflies, TileStats and ⋈init vector, with ``--emit-hierarchy``
    ``stats_out["hierarchy"]`` the Hierarchy, and with ``--trace``
    ``stats_out["timeline"]`` the timeline's digest and
    ``stats_out["trace"]`` the Tracer (the layer is off again after the
    run unless the caller had turned it on)."""
    from .. import obs

    seconds: dict = {}
    with obs.gc_pauses(seconds), obs.span("run", seconds=seconds,
                                          event=False):
        return _run_body(args, g, seconds)


def _run_body(args, g, seconds: dict) -> dict:
    """:func:`run`'s body: the process group, the obs layer's switch for
    ``--trace``, and :func:`_run` on the lead rank's stdout."""
    import contextlib
    import os

    from .. import obs

    n_dev = _world_size()
    _validate(args, n_dev)
    lead = True
    if n_dev > 1:
        import torch.distributed as dist

        from .mesh import init_peel_group

        if not dist.is_initialized():
            init_peel_group(args.device, args.backend)
        lead = dist.get_rank() == 0
    was_on = obs.enabled()
    if args.trace:
        obs.enable()
    with contextlib.ExitStack() as quiet:
        if not lead:   # rank 0 alone prints
            quiet.enter_context(contextlib.redirect_stdout(
                quiet.enter_context(open(os.devnull, "w"))))
        try:
            stats_out = _run(args, g, n_dev, lead, seconds)
        finally:
            tracer = obs.get_tracer()
            if args.trace and not was_on:
                obs.disable()
        if args.trace:
            if lead:
                tracer.save(args.trace)
            stats_out["trace"] = tracer
            print(f"[peel] trace: {len(tracer.events)} events -> "
                  f"{args.trace}")
    return stats_out


def _peel_distributed(args, g):
    """The distributed branch: a 1-D ``("peel",)`` mesh over every
    rank, the JAX CLI's entry-point arguments.  Returns (θ, stats row,
    PeelResult)."""
    from ..core import distributed as D
    from .mesh import make_peel_mesh

    mesh = make_peel_mesh(device=args.device)
    if args.kind == "wing":
        out = D.distributed_wing_decomposition(
            g, mesh, P_parts=args.parts, engine=args.engine,
            aligned=args.aligned, return_result=True)
    else:
        out = D.distributed_tip_decomposition(
            g, mesh, side=args.side, P_parts=args.parts,
            engine=args.engine, aligned=args.aligned,
            fd_driver=args.fd_driver, return_result=True)
    print(f"[peel] distributed over {out[1]['n_dev']} devices: {out[1]}")
    return out


def _run(args, g, n_dev: int, lead: bool, seconds: dict) -> dict:
    from .. import obs
    from ..core.graph import paper_proxy_dataset, powerlaw_bipartite
    from ..core.peel import tip_decomposition, wing_decomposition

    sup0 = tiled = None
    if args.edges:
        g, sup0, tiled = _ingest(args, seconds)
    elif g is None:
        if args.dataset:
            g = paper_proxy_dataset(args.dataset)
        else:
            g = powerlaw_bipartite(args.n_u, args.n_v, args.m, seed=args.seed)
    print(f"[peel] graph |U|={g.n_u} |V|={g.n_v} |E|={g.m}")
    seconds["graph"] = g.build_seconds()

    common = dict(P=args.parts, engine=args.engine, fd_driver=args.fd_driver,
                  use_pallas=args.use_pallas, fused=args.fused_fd,
                  sup0=sup0, device=args.device)
    t0 = time.perf_counter()
    if n_dev > 1:
        theta, stats_out, res = _peel_distributed(args, g)
    else:
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
        theta = res.theta
        stats_out = s.as_dict()
    seconds["peel"] = time.perf_counter() - t0
    seconds.update(res.seconds)
    with obs.span("peel.summary", seconds=seconds, event=False):
        if res.timeline is not None:
            stats_out["timeline"] = res.timeline.summary()
            print(f"[peel] timeline: {stats_out['timeline']}")
        stats_out["theta_sha256"] = sha256_int64(theta)
        print(f"[peel] theta: max={int(theta.max()) if theta.size else 0} "
              f"levels={len(set(theta.tolist()))} "
              f"sha256={stats_out['theta_sha256']}")
    h = (_emit_hierarchy(args, g, res, seconds)
         if args.emit_hierarchy and lead else None)
    if args.out and lead:
        with open(args.out, "w") as f:
            json.dump(dict(theta=theta.tolist(), stats=stats_out), f)
    stats_out["result"] = res
    stats_out["seconds"] = seconds
    if tiled is not None:
        stats_out["tiled_init"] = tiled
    if h is not None:
        stats_out["hierarchy"] = h
    return stats_out


class _Calls:
    """Count the calls of ``module.name`` inside the block (and, with
    ``record``, keep what ``record(*args, **kwargs)`` returns for
    each)."""

    def __init__(self, module, name: str, record=None):
        self.module, self.name, self.record = module, name, record
        self.calls: list = []

    def __enter__(self):
        self.orig = orig = getattr(self.module, self.name)

        def counted(*a, **k):
            self.calls.append(self.record(*a, **k) if self.record else None)
            return orig(*a, **k)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _dryrun(n: int = 512) -> int:
    """The distributed structure at ``n`` ranks, checked in one process.

    A fake process group (``torch.testing``'s ``FakeStore``, backend
    ``"fake"``) stands for ``n`` ranks; this process is rank 0, and
    collectives complete without moving data.  Where the JAX dry-run
    counts psums in the compiled HLO of its 512-device mesh, this counts
    the collectives that ``core.distributed`` issues (its per-phase
    counts), on ``powerlaw_bipartite(400, 200, 2000, seed=1)``:

    * one CD round of each layout: 2 for the beindex link and csr wedge
      rounds, 1 for the bloom-aligned, pair-aligned and both tip rounds;
    * FD of each body (beindex, csr wing, csr tip), P=64: 0 collectives,
      then one result ``all_gather``;
    * the (16, 32) ``("grp", "loc")`` mesh: the pair-aligned round's one
      logical reduction is 2 ``all_reduce`` calls, over groups of 32
      ranks, then 16;
    * the vmapped tip and wing FD (single device): one call of the
      batched driver for the whole Phase 2, 0 collectives;
    * the fused wing FD (single device): one ``fd_round_wing`` call a
      loop iteration, the loop FD_CHUNK iterations a host read, as the
      JAX dry-run finds ONE ``pallas_call`` in the while body.

    Runs on the CPU (the rounds' plain versions); needs no card."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..core import csr, fdpack, peel, peelspec
    from ..core import distributed as D
    from ..core.beindex import build_beindex
    from ..core.graph import powerlaw_bipartite
    from ..kernels import ops as kops
    from .mesh import fake_group, make_peel_mesh, make_peel_mesh_2d

    def counts(fn) -> dict:
        D.reset_collective_counts()
        fn()
        return D.collective_counts()

    def check(label, got, want):
        if got != want:
            raise AssertionError(f"{label}: {got}, want {want}")
        print(f"[peel-dryrun] {label}: {got} ✓")

    with fake_group(n):
        dev = torch.device("cpu")
        mesh = make_peel_mesh(n, device="cpu")
        g = powerlaw_bipartite(400, 200, 2000, seed=1)
        m = g.m
        be = build_beindex(g, dev)
        wed = csr.build_wedges(g)
        bf0 = wed.pair_butterflies0()
        pe_m = torch.zeros((m + 1,), dtype=torch.bool)
        pe_n = torch.zeros((g.n_u + 1,), dtype=torch.bool)
        sup_m = torch.zeros((m + 1,), dtype=torch.int32)
        sup_n = torch.zeros((g.n_u + 1,), dtype=torch.int32)
        print(f"[peel-dryrun] {n} fake ranks, graph |U|={g.n_u} "
              f"|V|={g.n_v} |E|={m}, {be.n_links} links, "
              f"{wed.n_wedges} wedges")

        def row(p, keys):
            return [torch.from_numpy(p[k][0]) for k in keys]

        # --- one CD round of each layout
        st = D.shard_links(be, m, n, 0, dev)
        fn = D.make_cd_round(mesh, "peel", st.nb, m)
        check("beindex link CD round, collectives",
              counts(lambda: fn(pe_m, st.alive_link, st.k_alive, sup_m,
                                st.le, st.lt, st.lb))["cd"], 2)
        bl = D.shard_links_bloom_aligned(be, m, n)
        fn = D.make_cd_round_bloom(mesh, "peel", bl["Bmax"], m)
        alive, k0, le, lt, lb = row(bl, ("alive", "k0", "le", "lt", "lb"))
        check("bloom-aligned CD round, collectives",
              counts(lambda: fn(pe_m, alive, k0, sup_m, le, lt, lb))["cd"],
              1)
        sw = D.shard_wedges(wed, n, 0, dev)
        fn = D.make_cd_round_csr(mesh, "peel", sw.n_pairs, m)
        check("csr wedge CD round, collectives",
              counts(lambda: fn(pe_m, sw.alive_w, sw.W_pad, sup_m, sw.we1,
                                sw.we2, sw.wp))["cd"], 2)
        pal = D.shard_wedges_pair_aligned(wed, n)
        pa = row(pal, ("alive", "W0", "we1", "we2", "wp"))
        fn = D.make_cd_round_csr_pair_aligned(mesh, "peel", pal["Pmax"], m)
        check("pair-aligned csr CD round, collectives",
              counts(lambda: fn(pe_m, pa[0], pa[1], sup_m, *pa[2:]))["cd"],
              1)
        fn = D.make_cd_round_tip_csr(mesh, "peel", g.n_u)
        for aligned in (False, True):
            tp = row(D.shard_tip_pairs(wed, bf0, n, aligned=aligned),
                     ("dst", "src", "bf"))
            check(f"tip csr CD round ({'vertex-aligned' if aligned else 'pair'}"
                  "), collectives",
                  counts(lambda: fn(pe_n, sup_n, *tp))["cd"], 1)

        # --- FD of each body: no collective, then the result gather
        res_b = peel.wing_decomposition(g, P=64, engine="beindex", be=be,
                                        device="cpu")
        res_c = peel.wing_decomposition(g, P=64, engine="csr", device="cpu")
        res_t = peel.tip_decomposition(g, side="u", P=64, engine="csr",
                                       device="cpu")
        for label, run_fd in (
            ("beindex", lambda: D.fd_peel_sharded(D.pack_fd_partitions(
                g, be, res_b.part, res_b.support_init,
                res_b.stats.p_effective), mesh, "peel", dev)),
            ("csr wing", lambda: D.fd_peel_sharded_csr(
                fdpack.pack_fd_partitions_csr(
                    wed, res_c.part, res_c.support_init,
                    res_c.stats.p_effective), mesh, "peel", dev)),
            ("csr tip", lambda: D.fd_peel_sharded_tip_csr(
                fdpack.pack_fd_partitions_tip_csr(
                    wed, bf0, res_t.part, res_t.support_init,
                    res_t.stats.p_effective, stacked=True),
                mesh, "peel", dev)),
        ):
            c = counts(run_fd)
            check(f"{label} FD at {n} ranks, collectives (fd, result)",
                  (c["fd"], c["result"]), (0, 1))

        # --- the staged reduction on the (16, 32) mesh
        mesh2 = make_peel_mesh_2d(n, device="cpu")
        fn = D.make_cd_round_csr_pair_aligned(mesh2, ("grp", "loc"),
                                              pal["Pmax"], m)
        with _Calls(dist, "all_reduce", record=lambda x, group=None, **k:
                    dist.get_world_size(group)) as ar:
            c = counts(lambda: fn(pe_m, pa[0], pa[1], sup_m, *pa[2:]))
        check(f"{tuple(mesh2.mesh.shape)} mesh, pair-aligned CD round: "
              "all_reduce calls and their group sizes",
              (c["cd"], ar.calls), (2, [32, 16]))

        # --- the vmapped FD drivers: one batched loop, no collective
        theta = np.zeros(g.n_u, np.int64)
        with _Calls(peel, "_fd_while_vmapped") as loop:
            c = counts(lambda: peel._tip_fd_vmapped_csr(
                wed, bf0, res_t.part, res_t.support_init, theta,
                res_t.stats.p_effective, False, dev))
        check("vmapped tip FD: batched driver calls, collectives",
              (len(loop.calls), sum(c.values())), (1, 0))
        if not np.array_equal(theta, res_t.theta):
            raise AssertionError("vmapped tip FD: θ differs")
        theta = np.zeros(m, np.int64)
        with _Calls(peel, "_fd_while_vmapped") as loop:
            c = counts(lambda: peel._wing_fd_vmapped_csr(
                wed, res_c.part, res_c.support_init, theta,
                res_c.stats.p_effective, False, False, dev))
        check("vmapped wing FD: batched driver calls, collectives",
              (len(loop.calls), sum(c.values())), (1, 0))

        # --- the fused wing FD: one kernel call a loop iteration
        theta = np.zeros(m, np.int64)
        with _Calls(kops, "fd_round_wing") as fused:
            rounds, _ = peel._wing_fd_vmapped_csr(
                wed, res_c.part, res_c.support_init, theta,
                res_c.stats.p_effective, False, True, dev)
        chunk = peelspec.FD_CHUNK
        check("fused wing FD: fd_round_wing calls",
              len(fused.calls), chunk * -(-int(rounds.max()) // chunk))
        if not np.array_equal(theta, res_c.theta):
            raise AssertionError("fused wing FD: θ differs")
    print("[peel-dryrun] all structural checks passed")
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The CLI's argument parser."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.peel",
        description="PBNG tip/wing decomposition (PyTorch port: one "
                    "device, or the ranks of a torch.distributed job)")
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
    ap.add_argument("--aligned", "--pair-aligned", dest="aligned",
                    action="store_true",
                    help="distributed one-reduction CD sharding: keep "
                         "every segment's items on one rank (wing csr: "
                         "pair-aligned wedges; tip csr: vertex-aligned "
                         "pair entries; wing beindex: bloom-aligned "
                         "links)")
    ap.add_argument("--dryrun", action="store_true",
                    help="check the distributed structure on a 512-rank "
                         "fake process group in this process (one "
                         "collective a round on the aligned layouts, none "
                         "in FD, the staged 2-D reduction, one batched "
                         "loop for the vmapped FD, one kernel call a "
                         "fused round)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="process group of a distributed run (WORLD_SIZE "
                         "> 1): default nccl on cuda (one rank a card), "
                         "gloo on cpu; gloo runs several ranks on one "
                         "card")
    return ap


def main(argv=None) -> int:
    """Parse ``argv`` and run (or dry-run)."""
    args = build_parser().parse_args(argv)
    if args.dryrun:
        return _dryrun()
    import torch.distributed as dist

    opened = not dist.is_initialized()
    try:
        run(args)
    finally:
        if opened and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
