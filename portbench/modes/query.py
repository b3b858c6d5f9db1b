"""Mode ``query``: a closed loop of one caller through the hierarchy
service, like a recommendation back end's batch scorer.

Set-up decomposes the graph once (``launch.peel.run`` with the
configuration's flags), builds the hierarchy on the card
(``hierarchy.build_hierarchy``), packs it into
``HierarchyService(h, batch=<mix's batch>)``, draws the mix's pool of
query batches from the seed and warms up on it.  The window calls
``query_batch`` with one batch of the pool after another, the next when
the last has returned; the last call that starts before ``--seconds``
have passed is finished and counted.  ``query_qps`` is the queries
answered over the window's seconds.

Each batch holds the op codes in equal shares (plus or minus one), in
an order drawn from the seed.  ``a`` and ``b`` are uniform over the
peeled side's vertices; for ``subtree_size`` ``a`` is a node, drawn as
a uniform fraction of the node count of the hierarchy it is asked of,
so that the program and the reference get the same fractions.

The traced segment is one more pass over the pool.  Every answer of the
window and the segment, and the set-up decomposition's theta, are held
to the reference.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

from portbench import graphgen
from portbench.reference import hierarchy, reference_theta

__all__ = ["SPANS", "setup", "window", "segment", "check"]

SPANS = (("repro_torch.hierarchy.serve", "_answer_batch"),)


def _pool(n_batches: int, batch: int, n_ent: int, seed: int):
    """(ops, a, b, node fraction) of every batch, drawn from ``seed``."""
    rng = np.random.default_rng([seed, 1])
    n_ops = len(hierarchy.OPS)
    ops = np.tile(np.arange(batch, dtype=np.int32) % n_ops, (n_batches, 1))
    ops = rng.permuted(ops, axis=1)
    a = rng.integers(0, n_ent, size=(n_batches, batch), dtype=np.int64)
    b = rng.integers(0, n_ent, size=(n_batches, batch), dtype=np.int64)
    frac = rng.random((n_batches, batch))
    return ops, a, b, frac


def _args(ops, a, frac, n_nodes: int):
    """``a`` with the node fraction of the ``subtree_size`` slots mapped
    onto ``n_nodes`` nodes."""
    node = np.minimum((frac * n_nodes).astype(np.int64), n_nodes - 1)
    return np.where(ops == hierarchy.OPS.index("subtree_size"), node, a)


def setup(ctx) -> dict:
    from repro_torch.core.graph import BipartiteGraph
    from repro_torch.hierarchy import build_hierarchy
    from repro_torch.hierarchy.serve import HierarchyService
    from repro_torch.launch import peel

    cfg, mix = ctx.config, ctx.traffic
    if cfg["decomposition"] != "tip":
        raise ValueError("the query mode's reference answers tip "
                         "hierarchies only")
    n_u, n_v, edges = graphgen.make_graph(cfg, ctx.seed)
    args = peel.build_parser().parse_args(
        list(cfg["flags"]) + ["--device", ctx.device])
    g = BipartiteGraph.from_edges(n_u, n_v, edges.copy())
    with contextlib.redirect_stdout(ctx.quiet):
        out = peel.run(args, g)
    res = out["result"]
    h = build_hierarchy(g, res, kind=cfg["decomposition"],
                        side=cfg.get("side", "u"), device=ctx.device)
    svc = HierarchyService(h, batch=int(mix["batch"]), device=ctx.device)
    n_ent = n_v if cfg.get("side", "u") == "v" else n_u
    ops, a, b, frac = _pool(int(mix["pool_batches"]), int(mix["batch"]),
                            n_ent, ctx.seed)
    state = dict(n_u=n_u, n_v=n_v, edges=edges, svc=svc,
                 theta=np.asarray(res.theta, dtype=np.int64), ops=ops,
                 a=_args(ops, a, frac, h.n_nodes).astype(np.int32),
                 b=b.astype(np.int32), frac=frac, pool_a=a, answers=[])
    for i in range(min(int(mix["warmup_batches"]), ops.shape[0])):
        svc.query_batch(ops[i], state["a"][i], b[i])
    return state


def _calls(state, t_end=None, n=None):
    """Batches of the pool in turn, until ``t_end`` (host clock) or ``n``
    calls; returns the host seconds of each call."""
    svc, ops, a, b = state["svc"], state["ops"], state["a"], state["b"]
    n_pool = ops.shape[0]
    lat, answers = [], state["answers"]
    i = len(answers)
    while True:
        j = i % n_pool
        t = time.perf_counter()
        if (n is not None and len(lat) >= n) or (
                t_end is not None and lat and t >= t_end):
            return lat
        out = svc.query_batch(ops[j], a[j], b[j])
        lat.append(time.perf_counter() - t)
        answers.append((j, out))
        i += 1


def window(ctx, state, rec) -> None:
    t0 = time.perf_counter()
    lat = _calls(state, t_end=t0 + ctx.seconds)
    rec["window_s"] = time.perf_counter() - t0
    rec["batch_s"] = lat
    n = len(lat) * state["ops"].shape[1]
    rec["attempted"] = n
    rec["end_to_end"] = {"query_qps": n / rec["window_s"]}


def segment(ctx, state, rec) -> None:
    calls = _calls(state, n=state["ops"].shape[0])
    rec["attempted"] += len(calls) * state["ops"].shape[1]


def check(ctx, state, rec):
    """theta of the set-up decomposition, and every answer, against the
    reference's (counts of entries that differ; limit 0, exact)."""
    n_u, n_v, edges = state["n_u"], state["n_v"], state["edges"]
    want_theta = reference_theta(ctx.config, n_u, n_v, edges)
    got = state["theta"]
    theta_bad = (int(np.count_nonzero(got != want_theta))
                 if got.shape == want_theta.shape else int(want_theta.size))
    if ctx.config.get("side", "u") == "v":
        n_u, n_v, edges = n_v, n_u, edges[:, ::-1]
    forest = hierarchy.tip_forest(n_u, n_v, edges, want_theta)
    n_nodes = forest["node_level"].size
    ops, b = state["ops"], state["b"].astype(np.int64)
    a = _args(ops, state["pool_a"], state["frac"], n_nodes)
    want = hierarchy.answers(forest, ops.ravel(), a.ravel(),
                             b.ravel()).reshape(ops.shape)
    wrong = sum(int(np.count_nonzero(out != want[j]))
                for j, out in state["answers"])
    return [("theta_mismatch", theta_bad, 0),
            ("answer_mismatch", wrong, 0)], wrong
