"""Streaming peel service driver of the PyTorch port: replay an
edge-event trace through the incremental updater.

The same flags and ``[stream]`` lines as the JAX package's ``python -m
repro.launch.stream``, plus ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions; no fallback where there is no card)::

    PYTHONPATH=src python -m repro_torch.launch.stream --epochs 4
    PYTHONPATH=src python -m repro_torch.launch.stream --dryrun
    PYTHONPATH=src python -m repro_torch.launch.stream --device cpu \
        --kind tip --events trace.jsonl --batch 64

The job loads/generates a bipartite graph, stands up a
:class:`repro_torch.streaming.StreamState`, then feeds it micro-epochs of
edge inserts/deletes — either replayed from a JSONL trace
(``--events``, see ``repro_torch.streaming.events.load_trace``) or
synthesized against the live edge set (``--epochs``/``--batch``/
``--p-delete``).  Per epoch it prints what the updater actually did:
net events after coalescing, dirty partitions / dirty hierarchy
levels vs totals, the stale-serving bound (how many old-forest nodes
and packed-forest entities an in-flight reader could see stale
answers from — everything else is untouched by the repair), and the
repair/epoch wall time.

Serving never blocks: the previous epoch's forest stays readable
until the atomic swap, which the driver demonstrates by answering a
densest-leaves query from the pre-epoch snapshot while the repair for
that epoch is already committed.  ``--dryrun`` is the self-check:
stream a few epochs on a small graph on ``--device`` and assert θ, the
stats row, and every packed-forest array are bit-identical to a
from-scratch re-peel of the materialized graph (the same invariant
``tests/test_torch_streaming.py`` checks exhaustively).
"""
from __future__ import annotations

import argparse
import json
import sys


class LaunchError(SystemExit):
    """Unsupported flag combination — raised instead of silently
    falling back to a different engine/driver."""

    def __init__(self, msg: str):
        super().__init__(f"[stream] error: {msg}")


def _validate(args) -> None:
    if args.engine is None:
        args.engine = "csr"
    if args.engine not in ("csr", "dense"):
        raise LaunchError(
            "streaming localizes FD re-runs per partition; that needs "
            "the csr or dense engine (beindex has no partition-local "
            "FD entry) — pass --engine csr|dense")
    if args.fd_driver not in ("device", "host", "vmapped"):
        raise LaunchError(
            "streaming supports the per-partition fd_drivers (device/"
            "host — dirty partitions re-run alone) and vmapped (the "
            "whole Phase 2 redispatches as its one batched loop); "
            "fused is not wired — pass --fd-driver device|host|vmapped")
    if args.fd_driver == "vmapped" and args.engine != "csr":
        raise LaunchError(
            "fd_driver='vmapped' is the csr single-dispatch Phase 2 — "
            "pass --engine csr")
    if args.kind == "wing" and args.side != "u":
        raise LaunchError("wing peels edges; there is no --side (use u)")
    if args.batch <= 0:
        raise LaunchError("--batch must be positive")


def _epoch_batches(args, st):
    """Yield one event list per micro-epoch."""
    from ..streaming import load_trace, make_random_events

    if args.events:
        trace = load_trace(args.events)
        print(f"[stream] trace: {len(trace)} events from {args.events} "
              f"in batches of {args.batch}")
        for i in range(0, len(trace), args.batch):
            yield trace[i:i + args.batch]
    else:
        for e in range(args.epochs):
            # synthesized against the LIVE edge set so deletes stay
            # meaningful as the graph drifts
            yield make_random_events(
                st.g, args.batch, seed=args.seed + 1 + e,
                p_delete=args.p_delete)


def _densest(h):
    """Tiny serving query used to demonstrate the stale snapshot."""
    from ..hierarchy import top_densest_leaves

    top = top_densest_leaves(h, 1)
    if len(top["density"]) == 0:
        return "-"
    return f"{float(top['density'][0]):.3f}@k={int(top['level'][0])}"


def _run(args) -> int:
    from ..core.graph import paper_proxy_dataset, powerlaw_bipartite
    from ..streaming import StreamConfig, StreamState

    _validate(args)
    if args.dataset:
        g = paper_proxy_dataset(args.dataset)
    else:
        g = powerlaw_bipartite(args.n_u, args.n_v, args.m, seed=args.seed)
    print(f"[stream] graph |U|={g.n_u} |V|={g.n_v} |E|={g.m}")

    cfg = StreamConfig(kind=args.kind, side=args.side, engine=args.engine,
                       P=args.parts, fd_driver=args.fd_driver)
    st = StreamState.initial(g, cfg, device=args.device)
    h0 = st.hierarchy
    print(f"[stream] init: kind={cfg.kind} engine={cfg.engine} "
          f"fd_driver={cfg.fd_driver} p_eff={st.result.stats.p_effective} "
          f"theta_max={int(st.result.theta.max()) if st.result.theta.size else 0} "
          f"forest={h0.n_nodes} nodes / {int(h0.levels.size)} levels")

    reports = []
    for events in _epoch_batches(args, st):
        # the pre-epoch snapshot a reader would be holding mid-repair
        snap = st.hierarchy
        rep = st.apply_epoch(events)
        reports.append(rep.as_dict())
        # stale-but-bounded serving: the snapshot stays fully queryable
        # after the swap; at most `stale_nodes` of its subtrees
        # (`stale_entities` packed entities) were invalidated by this
        # epoch's repair
        q_old, q_new = _densest(snap), _densest(st.hierarchy)
        tag = "noop " if rep.noop else ""
        print(f"[stream] epoch {rep.epoch}: {tag}"
              f"events={rep.n_events} net=+{rep.n_inserts}/-{rep.n_deletes} "
              f"dirty={rep.partitions_dirty}/{rep.p_eff} parts, "
              f"{rep.levels_dirty}/{rep.levels_total} levels; "
              f"stale<=({rep.stale_nodes} nodes, {rep.stale_entities} ents); "
              f"repair={rep.repair_ms:.1f}ms epoch={rep.epoch_ms:.1f}ms; "
              f"densest {q_old} -> {q_new}")

    ne = len(reports)
    if ne:
        avg = sum(r["epoch_ms"] for r in reports) / ne
        davg = sum(r["partitions_dirty"] for r in reports) / ne
        print(f"[stream] {ne} epochs: avg epoch {avg:.1f}ms, "
              f"avg dirty partitions {davg:.1f}, final |E|={st.g.m} "
              f"theta_max={int(st.result.theta.max()) if st.result.theta.size else 0}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(
                config=dict(kind=cfg.kind, side=cfg.side, engine=cfg.engine,
                            parts=cfg.P, fd_driver=cfg.fd_driver),
                epochs=reports,
                theta=st.result.theta.tolist(),
                metrics=st.metrics.snapshot(),
            ), f)
        print(f"[stream] wrote {ne} epoch reports -> {args.out}")
    return 0


def _dryrun(device) -> int:
    """Self-check: per-epoch bit-identity against from-scratch re-peels,
    for both entity kinds, on a small graph, on ``device``."""
    import numpy as np

    from ..core.graph import powerlaw_bipartite
    from ..core.peel import tip_decomposition, wing_decomposition
    from ..hierarchy import build_hierarchy
    from ..streaming import StreamConfig, StreamState, make_random_events

    g0 = powerlaw_bipartite(60, 40, 260, seed=3)
    for kind in ("wing", "tip"):
        cfg = StreamConfig(kind=kind, engine="csr", P=8, fd_driver="device")
        st = StreamState.initial(g0, cfg, device=device)
        dirt = []
        for e in range(3):
            events = make_random_events(st.g, 14, seed=100 + e)
            rep = st.apply_epoch(events)
            dirt.append(f"{rep.partitions_dirty}/{rep.p_eff}")
            if kind == "wing":
                ref = wing_decomposition(st.g, P=8, engine="csr",
                                         device=device)
            else:
                ref = tip_decomposition(st.g, side="u", P=8, engine="csr",
                                        device=device)
            assert np.array_equal(st.result.theta, ref.theta), \
                f"{kind} epoch {e}: incremental theta diverged"
            sa, sb = st.result.stats.as_dict(), ref.stats.as_dict()
            assert sa == sb, f"{kind} epoch {e}: stats diverged {sa} {sb}"
            h_ref = build_hierarchy(st.g, ref, kind=kind, device=device)
            h = st.hierarchy
            for f_ in ("node_level", "parent", "entity_node", "member_off",
                       "member_ids", "child_off", "child_ids", "tin",
                       "tout", "ent_order", "estart", "eend", "node_m",
                       "node_nu", "node_nv"):
                assert np.array_equal(getattr(h, f_), getattr(h_ref, f_)), \
                    f"{kind} epoch {e}: forest field {f_} diverged"
            assert np.allclose(h.density, h_ref.density), \
                f"{kind} epoch {e}: forest density diverged"
        print(f"[stream-dryrun] {kind}: 3 epochs bit-identical to "
              f"from-scratch re-peel (theta, stats, packed forest) ✓ "
              f"dirty={dirt}")
    print("[stream-dryrun] incremental maintenance = from-scratch "
          "semantics on both entity kinds ✓")
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The CLI's argument parser."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.stream",
        description="streaming peel: replay edge events through the "
                    "incremental updater (PyTorch port)")
    ap.add_argument("--kind", choices=["wing", "tip"], default="wing",
                    help="entity universe to maintain incrementally: "
                         "edges (wing) or vertices (tip)")
    ap.add_argument("--side", default="u",
                    help="tip only: which vertex set carries theta")
    ap.add_argument("--engine", default=None, choices=["csr", "dense"],
                    help="peel engine; streaming needs a partition-"
                         "local FD entry, so csr (default) or dense")
    ap.add_argument("--fd-driver", default="device",
                    choices=["device", "host", "vmapped"],
                    help="FD driver for the per-epoch re-runs: device/"
                         "host re-peel only the dirty partitions; "
                         "vmapped (csr only) redispatches the whole "
                         "Phase 2 as its one batched while_loop")
    ap.add_argument("--parts", type=int, default=16)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--n-u", type=int, default=400)
    ap.add_argument("--n-v", type=int, default=200)
    ap.add_argument("--m", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--events", default=None, metavar="PATH",
                    help="JSONL edge-event trace to replay (one "
                         '{"op": "+"|"-", "u": int, "v": int} per '
                         "line), consumed in --batch sized "
                         "micro-epochs; default: synthesize --epochs "
                         "epochs of --batch random events")
    ap.add_argument("--epochs", type=int, default=4,
                    help="synthesized micro-epochs when no --events "
                         "trace is given")
    ap.add_argument("--batch", type=int, default=32,
                    help="events per micro-epoch")
    ap.add_argument("--p-delete", type=float, default=0.3,
                    help="synthesized traffic: probability an event "
                         "deletes an existing edge")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write per-epoch reports + final theta + "
                         "metrics snapshot as JSON")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable the observability layer and write a "
                         "Chrome-trace JSON of the run (stream.epoch/"
                         "stream.cd/stream.fd/stream.repair spans, "
                         "hierarchy.repair levels).  Off by default, "
                         "and off changes nothing")
    ap.add_argument("--dryrun", action="store_true",
                    help="small-graph self-check: per-epoch bit-"
                         "identity vs from-scratch re-peel, both kinds")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    return ap


def main(argv=None) -> int:
    """Parse ``argv`` and run; returns the exit code."""
    from .. import obs

    args = build_parser().parse_args(argv)
    if args.trace:
        obs.enable()
    rc = _dryrun(args.device) if args.dryrun else _run(args)
    if args.trace:
        tracer = obs.get_tracer()
        tracer.save(args.trace)
        print(f"[stream] trace: {len(tracer.events)} events -> "
              f"{args.trace}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
