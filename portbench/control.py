#!/usr/bin/env python3
"""The control of the benchmark's correctness check: the plain
reference put in the program's place, with its supports held in a float
of fewer significand bits (8: bfloat16), through the same check that
judges the program.  The configurations state exact integer theta, so
the control breaks that guarantee; the check has to find it::

    python3 portbench/control.py --workload bcl-56k.decompose \\
        --seeds 11 12 13 [--bits 8]

prints one JSON line a seed: the check's numbers and their limits.
Needs no card: the reference is NumPy and SciPy.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["control_checks"]


def control_checks(workload: str, seed: int, bits: int, root: str,
                   pb: str) -> list:
    """The check's [(name, value, limit)] with the control's answers in
    the program's place, for one run seed."""
    import numpy as np

    from portbench import graphgen, harness
    from portbench.reference import hierarchy, reference_theta

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[wl["config"]]
    ctx = harness.Context(
        config=harness._json(os.path.join(root, cfg_file)),
        traffic=harness._json(os.path.join(pb, "traffic",
                                           wl["traffic"] + ".json")),
        seed=seed, seconds=0.0, device="cpu")
    mode = harness.load_file(os.path.join(pb, "modes",
                                          ctx.traffic["mode"] + ".py"))
    n_u, n_v, edges = graphgen.make_graph(ctx.config, seed)
    theta = reference_theta(ctx.config, n_u, n_v, edges,
                            significand_bits=bits)
    state = dict(n_u=n_u, n_v=n_v, edges=edges, thetas=[theta])
    if ctx.traffic["mode"] == "query":
        pn_u, pn_v, pe = n_u, n_v, edges
        if ctx.config.get("side", "u") == "v":
            pn_u, pn_v, pe = n_v, n_u, edges[:, ::-1]
        forest = hierarchy.tip_forest(pn_u, pn_v, pe, theta)
        mix = ctx.traffic
        ops, a, b, frac = mode._pool(int(mix["pool_batches"]),
                                     int(mix["batch"]), pn_u, seed)
        a_run = mode._args(ops, a, frac, forest["node_level"].size)
        got = hierarchy.answers(forest, ops.ravel(), a_run.ravel(),
                                b.ravel()).reshape(ops.shape)
        state.update(theta=theta, ops=ops, b=b, frac=frac, pool_a=a,
                     answers=[(j, got[j].astype(np.int32))
                              for j in range(ops.shape[0])])
    checks, _ = mode.check(ctx, state, {})
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--bits", type=int, default=8,
                    help="significand bits of the control's supports "
                         "(8 bfloat16, 11 float16, 24 float32)")
    args = ap.parse_args(argv)
    pb = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(pb)
    for seed in args.seeds:
        checks = control_checks(args.workload, seed, args.bits, root, pb)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "bits": args.bits,
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, v, lim in checks},
                          "correct": all(v <= lim for _, v, lim in checks)}),
              flush=True)
    return 0


if __name__ == "__main__":
    _root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:1] = [_root, os.path.join(_root, "src")]
    sys.exit(main())
