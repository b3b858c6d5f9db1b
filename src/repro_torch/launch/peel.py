"""Single-device csr peeling CLI of the PyTorch port.

The same flags as the JAX package's ``python -m repro.launch.peel`` for
``--kind/--engine/--fd-driver/--fused-fd/--use-pallas/--parts/--dataset/
--n-u/--n-v/--m/--seed/--side/--out``, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain versions of the kernels).  It prints the
same ``[peel] theta: ... sha256=...`` line, so a run of each CLI on the
same flags can be compared digest for digest::

    PYTHONPATH=src python -m repro_torch.launch.peel --kind tip
    PYTHONPATH=src python -m repro_torch.launch.peel --kind wing --engine csr

Unsupported flag combinations exit with the JAX CLI's error texts; the
engines not ported yet (``beindex``, the wing default, and ``dense``)
exit naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys

_NOT_PORTED = {
    "beindex": "ROADMAP queue 1, item 8",
    "dense": "ROADMAP queue 1, item 9",
}


class LaunchError(SystemExit):
    """Unsupported flag combination — raised instead of silently
    falling back to a different engine/driver."""

    def __init__(self, msg: str):
        super().__init__(f"[peel] error: {msg}")


def _validate(args) -> None:
    """Resolve the per-kind engine and fused-FD defaults as the JAX CLI
    does for one device, then reject unsupported combinations."""
    if args.engine is None:
        args.engine = "beindex" if args.kind == "wing" else "csr"
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
    if args.engine != "csr":
        raise LaunchError(
            f"--engine {args.engine} is not ported to repro_torch yet "
            f"({_NOT_PORTED[args.engine]}); pass --engine csr")
    if args.fused_fd is None:
        args.fused_fd = args.fd_driver in ("device", "vmapped")


def sha256_int64(a) -> str:
    """sha256 of an array's int64 bytes — the CLI's θ digest."""
    import numpy as np

    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(a, dtype=np.int64)).tobytes()
    ).hexdigest()


def run(args, g=None) -> dict:
    """Peel ``g`` (default: the graph the flags describe) and print the
    JAX CLI's summary lines.  Returns the stats row with
    ``theta_sha256``; ``stats_out["result"]`` holds the PeelResult."""
    from ..core.graph import paper_proxy_dataset, powerlaw_bipartite
    from ..core.peel import tip_decomposition, wing_decomposition

    _validate(args)
    if g is None:
        if args.dataset:
            g = paper_proxy_dataset(args.dataset)
        else:
            g = powerlaw_bipartite(args.n_u, args.n_v, args.m, seed=args.seed)
    print(f"[peel] graph |U|={g.n_u} |V|={g.n_v} |E|={g.m}")

    common = dict(P=args.parts, engine=args.engine, fd_driver=args.fd_driver,
                  use_pallas=args.use_pallas, fused=args.fused_fd,
                  device=args.device)
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
    stats_out["theta_sha256"] = sha256_int64(theta)
    print(f"[peel] theta: max={int(theta.max()) if theta.size else 0} "
          f"levels={len(set(theta.tolist()))} "
          f"sha256={stats_out['theta_sha256']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(theta=theta.tolist(), stats=stats_out), f)
    stats_out["result"] = res
    return stats_out


def build_parser() -> argparse.ArgumentParser:
    """The CLI's argument parser."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.peel",
        description="PBNG tip/wing decomposition on the csr engine "
                    "(PyTorch port, single device)")
    ap.add_argument("--kind", "--mode", dest="kind",
                    choices=["wing", "tip"], default="wing",
                    help="entity universe to peel: edges (wing) or "
                         "vertices (tip)")
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--n-u", type=int, default=400)
    ap.add_argument("--n-v", type=int, default=200)
    ap.add_argument("--m", type=int, default=2000)
    ap.add_argument("--parts", type=int, default=16)
    ap.add_argument("--engine", default=None,
                    choices=["beindex", "dense", "csr"],
                    help="csr (the only ported engine); default as the "
                         "JAX CLI: beindex for wing, csr for tip")
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
                         "updates); the JAX CLI's flag name")
    ap.add_argument("--side", default="u")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
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
