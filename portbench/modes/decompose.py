"""Mode ``decompose``: whole decompositions of the configuration's graph,
back to back.

One decomposition is ``repro_torch.launch.peel.run(args, g)`` with the
configuration's CLI flags, on a fresh ``BipartiteGraph`` built from
copies of the run's edge arrays; its theta is
``stats_out["result"].theta``.  Set-up makes the graph and runs one
decomposition, which builds or loads the kernels and warms every shape.
The window runs decompositions from its start; the last one that starts
before ``--seconds`` have passed is finished and counted, and the
window ends with it.  ``decomp_s`` is the window's seconds over the
decompositions it completed.

The traced segment is one more decomposition.  Every decomposition of
the window and the segment is held to the reference's theta.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

from portbench import graphgen
from portbench.reference import reference_theta

__all__ = ["SPANS", "setup", "window", "segment", "check",
           "decompose_once"]

# host spans of the traced segment: the spec build, the two phases
SPANS = (("repro_torch.core.peel", "build_peel_spec"),
         ("repro_torch.core.peelspec", "cd_loop"),
         ("repro_torch.core.peelspec", "run_fd"))


def setup(ctx) -> dict:
    from repro_torch.launch import peel

    n_u, n_v, edges = graphgen.make_graph(ctx.config, ctx.seed)
    args = peel.build_parser().parse_args(
        list(ctx.config["flags"]) + ["--device", ctx.device])
    state = dict(n_u=n_u, n_v=n_v, edges=edges, args=args, thetas=[])
    decompose_once(ctx, state)          # builds, loads and warms up
    state["thetas"].clear()
    return state


def decompose_once(ctx, state) -> dict:
    """One decomposition; keeps its theta in ``state["thetas"]`` and
    returns its seconds and kernel launches."""
    from repro_torch.core.graph import BipartiteGraph
    from repro_torch.kernels import ops
    from repro_torch.launch import peel

    before = sum(ops.launch_counts().values())
    t0 = time.perf_counter()
    g = BipartiteGraph.from_edges(state["n_u"], state["n_v"],
                                  state["edges"].copy())
    with contextlib.redirect_stdout(ctx.quiet):
        out = peel.run(state["args"], g)
    state["thetas"].append(np.asarray(out["result"].theta, dtype=np.int64))
    return dict(seconds=dict(out["seconds"]), total=time.perf_counter() - t0,
                launches=sum(ops.launch_counts().values()) - before)


def window(ctx, state, rec) -> None:
    decomps = []
    t0 = time.perf_counter()
    while not decomps or time.perf_counter() - t0 < ctx.seconds:
        decomps.append(decompose_once(ctx, state))
    rec["window_s"] = time.perf_counter() - t0
    rec["decomps"] = decomps
    for d in decomps:
        sec = d["seconds"]
        print(f"[portbench] decomposition {d['total']:.3f} s: peel "
              f"{sec['peel']:.3f}, cd {sec['cd']:.3f}, fd {sec['fd']:.3f}",
              file=ctx.quiet)
    rec["attempted"] = len(decomps)
    rec["end_to_end"] = {"decomp_s": rec["window_s"] / len(decomps)}


def segment(ctx, state, rec) -> None:
    decompose_once(ctx, state)


def check(ctx, state, rec):
    """theta of every decomposition against the reference's: the count
    of entries that differ, over all of them (limit 0, exact)."""
    want = reference_theta(ctx.config, state["n_u"], state["n_v"],
                           state["edges"])
    bad = [int(np.count_nonzero(t != want)) if t.shape == want.shape
           else int(want.size) for t in state["thetas"]]
    return [("theta_mismatch", sum(bad), 0)], sum(1 for b in bad if b)
