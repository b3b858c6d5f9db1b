"""The port's beindex and dense engines on the CPU against the JAX
package.

* all 32 beindex and dense cells of ``tests/goldens/peel_goldens.json``,
  field for field;
* ``build_beindex`` array-equal to the reference's, on the edge cases
  too (no butterflies, isolated and degree-1 vertices, tied degrees,
  unsorted edge rows), and ``torch_beindex.json``, the card tests'
  record of the reference, held to it; its wedge-slot enumeration
  against a brute force on a row of 2 048 neighbours;
* the BE-Index update (``_wing_update``), one ``ops.bloom_update`` round
  against it (the JAX test's identity), the dense tip engine under every
  ``batch_recount`` setting and the dense wing engine with an injected
  ⋈init, each against the JAX engine on graphs drawn with numpy;
* the beindex FD phase (every partition in one ``fd_wing_beindex``
  launch; on the CPU its plain version) against the JAX package's host
  cascade: θ, ρ_fd, updates and every FD timeline row, on the goldens'
  graphs at several P, with one partition, with a partition that has no
  pair of its own, and for an ``only=`` subset;
* the BE_PC baseline and ``bup_levels`` against the reference;
* the dense engine's memory guard.

Every count is an exact integer: the tolerance is exact equality.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import peel as jpeel
from repro.core import peelspec as jspec
from repro.core import ref as core_ref
from repro.core.beindex import build_beindex as jbuild_beindex
from repro.core.graph import BipartiteGraph as JGraph
from repro_torch import obs as tobs
from repro_torch.core import graph as tgraph
from repro_torch.core import peel as tpeel
from repro_torch.core import peelspec as tspec
from repro_torch.core.beindex import build_beindex
from repro_torch.kernels import ops

# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens", "peel_goldens.json")
GRAPHS = {
    "rb30": lambda: tgraph.random_bipartite(30, 24, 140, seed=0),
    "rb25": lambda: tgraph.random_bipartite(25, 20, 100, seed=1),
    "pl80": lambda: tgraph.powerlaw_bipartite(80, 40, 350, seed=2),
    "pl60": lambda: tgraph.powerlaw_bipartite(60, 50, 300, seed=3),
}
FIELDS = ("theta", "part", "ranges", "support_init", "rho_cd",
          "rho_fd_total", "rho_fd_max", "updates", "recounts",
          "p_effective")
# the 32 cells of the two engines: wing × {beindex, dense}, tip × dense ×
# side, each graph at P = 3 and 6
CELLS = sorted(
    [f"wing.{g}.P{P}.{e}.device" for g in GRAPHS for P in (3, 6)
     for e in ("beindex", "dense")]
    + [f"tip.{g}.P{P}.{s}.dense.device" for g in GRAPHS for P in (3, 6)
       for s in "uv"])
BE_ARRAYS = ("bloom_k", "link_edge", "link_twin", "link_bloom")
# the JAX package's BE-Index of small graphs, recorded for the card tests
# by ``tests/goldens/record_torch_beindex.py``; the edge cases' graphs
# are defined there
BE_GOLDEN = os.path.join(os.path.dirname(GOLDENS), "torch_beindex.json")
BE_EDGE_CASES = ("no_edges", "no_butterflies", "isolated_and_degree1",
                 "tied_degrees", "unsorted_rows")


def _graph_pair(seed, n_u=18, n_v=14, m=80):
    rng = np.random.default_rng(seed)
    raw = np.stack([rng.integers(0, n_u, m), rng.integers(0, n_v, m)], 1)
    return (JGraph.from_edges(n_u, n_v, raw),
            tgraph.BipartiteGraph.from_edges(n_u, n_v, raw))


def _snapshot(res) -> dict:
    s = res.stats
    return dict(
        theta=np.asarray(res.theta).tolist(),
        part=np.asarray(res.part).tolist(),
        ranges=np.asarray(res.ranges).tolist(),
        support_init=np.asarray(res.support_init).tolist(),
        rho_cd=s.rho_cd, rho_fd_total=s.rho_fd_total,
        rho_fd_max=s.rho_fd_max, updates=s.updates,
        recounts=s.recounts, p_effective=s.p_effective,
    )


@pytest.fixture(scope="module")
def goldens():
    with open(GOLDENS) as f:
        return json.load(f)


@pytest.mark.parametrize("key", CELLS)
def test_engine_golden_cells(goldens, key):
    parts = key.split(".")
    g = GRAPHS[parts[1]]()
    kw = dict(P=int(parts[2][1:]), engine=parts[-2], device="cpu")
    if parts[0] == "wing":
        res = tpeel.wing_decomposition(g, **kw)
    else:
        res = tpeel.tip_decomposition(g, side=parts[3], **kw)
    assert res.stats.engine == parts[-2] and res.stats.fd_driver == "host"
    got = _snapshot(res)
    for f in FIELDS:
        assert got[f] == goldens[key][f], f


def test_cells_are_all_the_goldens_of_the_two_engines(goldens):
    assert CELLS == sorted(k for k in goldens if "csr" not in k.split("."))


def _recorded_graph_pair(name):
    """Both packages' graphs of a ``torch_beindex.json`` entry, with its
    edge rows in their recorded order."""
    with open(BE_GOLDEN) as f:
        rec = json.load(f)[name]
    e = np.asarray(rec["edges"], dtype=np.int32).reshape(-1, 2)
    return (JGraph(rec["n_u"], rec["n_v"], e),
            tgraph.BipartiteGraph(rec["n_u"], rec["n_v"], e.copy()))


@pytest.mark.parametrize("name", [*sorted(GRAPHS), "numpy", *BE_EDGE_CASES])
def test_build_beindex_equals_reference(name):
    if name == "numpy":
        jg, tg = _graph_pair(7, n_u=25, n_v=19, m=160)
    elif name in GRAPHS:
        tg = GRAPHS[name]()
        jg = JGraph.from_edges(tg.n_u, tg.n_v, tg.edges)
    else:
        jg, tg = _recorded_graph_pair(name)
    want = jbuild_beindex(jg)
    got = build_beindex(tg)
    assert got.nb == want.nb and got.n_links == want.n_links
    for k in BE_ARRAYS:
        a, b = getattr(got, k), getattr(want, k)
        np.testing.assert_array_equal(a, b, err_msg=k)
        assert a.dtype == b.dtype == np.int32, k
    assert got.total_butterflies() == want.total_butterflies()
    np.testing.assert_array_equal(got.edge_support(tg.m),
                                  want.edge_support(tg.m))


def _index_digest(be) -> dict:
    import hashlib

    out = dict(nb=be.nb, n_links=be.n_links)
    out.update({f"{k}_sha256": hashlib.sha256(getattr(be, k).tobytes())
                .hexdigest() for k in BE_ARRAYS})
    return out


@pytest.mark.parametrize("name", [*sorted(GRAPHS), "numpy", *BE_EDGE_CASES])
def test_recorded_beindex_is_the_reference(name):
    """``torch_beindex.json``, which the card tests hold the CUDA build
    to, is the JAX package's index of its graphs, and each edge case is
    what its name says."""
    jg, tg = _recorded_graph_pair(name)
    if name == "numpy":
        want = _graph_pair(7, n_u=25, n_v=19, m=160)[1]
    elif name in GRAPHS:
        want = GRAPHS[name]()
    else:
        want = tg
    np.testing.assert_array_equal(tg.edges, want.edges)
    with open(BE_GOLDEN) as f:
        rec = json.load(f)[name]["index"]
    assert _index_digest(jbuild_beindex(jg)) == rec
    du, dv = tg.degrees()
    if name in ("no_edges", "no_butterflies"):
        assert rec["nb"] == rec["n_links"] == 0
        assert build_beindex(tg).total_butterflies() == 0
        assert (name == "no_edges") == (tg.m == 0)
    elif name == "isolated_and_degree1":
        assert min(du.min(), dv.min()) == 0
        assert (du == 1).any() and (dv == 1).any() and rec["nb"] > 0
    elif name == "tied_degrees":
        assert len(set(du) | set(dv)) == 1 and rec["nb"] > 0
    elif name == "unsorted_rows":
        order = np.lexsort((tg.edges[:, 1], tg.edges[:, 0]))
        assert (order != np.arange(tg.m)).any() and rec["nb"] > 0


def _wedge_slots_brute(g):
    """Every wedge slot of ``g``'s combined-id CSR by ``np.triu_indices``,
    row by row: (key or -1, e_lo, e_hi) in (mid, i, j) order."""
    du, dv = g.degrees()
    deg = np.concatenate([du, dv])
    label = np.empty(g.n, dtype=np.int64)
    label[np.lexsort((np.arange(g.n), -deg))] = np.arange(g.n)
    rows = [[] for _ in range(g.n)]
    for e, (u, v) in enumerate(g.edges.tolist()):
        rows[u].append((g.n_u + v, e))
        rows[g.n_u + v].append((u, e))
    keys, lo, hi = [], [], []
    for mid, row in enumerate(rows):
        if len(row) < 2:
            continue
        nbr, eid = (np.array(x, dtype=np.int64) for x in zip(*row))
        i, j = np.triu_indices(len(row), 1)
        a, b = nbr[i], nbr[j]
        keep = label[mid] > np.minimum(label[a], label[b])
        keys.append(np.where(keep, np.minimum(a, b) * g.n
                             + np.maximum(a, b), -1))
        lo.append(np.where(a < b, eid[i], eid[j]))
        hi.append(np.where(a < b, eid[j], eid[i]))
    return tuple(np.concatenate(x) for x in (keys, lo, hi))


def test_beindex_wedge_slots_on_a_long_row():
    """The BE-Index build's wedge enumeration on a star of degree 2 048
    (2 096 128 slots in one row) plus random edges, its rows out of
    edge-index order: every slot's key and edge ids equal a brute force
    over ``np.triu_indices``."""
    from repro_torch.core.beindex import _wedge_inputs, _wedge_slots

    rng = np.random.default_rng(0)
    n_u, n_v = 40, 2_048
    star = np.stack([np.zeros(n_v, np.int64), np.arange(n_v)], 1)
    extra = np.stack([rng.integers(1, n_u, 600), rng.integers(0, 64, 600)], 1)
    edges = np.unique(np.concatenate([star, extra]), axis=0)
    g = tgraph.BipartiteGraph(n_u, n_v, edges[rng.permutation(len(edges))]
                              .astype(np.int32))
    got = _wedge_slots(*_wedge_inputs(g, torch.device("cpu")))
    want = _wedge_slots_brute(g)
    assert want[0].size > n_v * (n_v - 1) // 2
    assert (want[0] >= 0).any() and (want[0] < 0).any()
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), y)


def test_build_beindex_on_wing_60k_equals_the_recorded_index():
    """The full-size BE-Index (50 630 blooms) against the JAX package's,
    by the sha256 of each array in ``tests/goldens/torch_engines.json``."""
    import hashlib

    with open(os.path.join(os.path.dirname(GOLDENS),
                           "torch_engines.json")) as f:
        want = json.load(f)["wing-60k"]
    be = build_beindex(tgraph.powerlaw_bipartite(**want["graph"]))
    got = dict(nb=be.nb, n_links=be.n_links, max_pairs=int(be.bloom_k.max()))
    got.update({f"{k}_sha256": hashlib.sha256(getattr(be, k).tobytes())
                .hexdigest() for k in BE_ARRAYS})
    assert got == want["index"]


@pytest.mark.parametrize("seed", [8, 21])
def test_bloom_update_round_equals_the_engine_update(seed):
    """One ``ops.bloom_update`` round gives ``_wing_update``'s supports
    (the JAX package's ``test_bloom_update_kernel_equals_peeling_round``),
    and ``_wing_update`` equals the JAX one on every output."""
    jg, tg = _graph_pair(seed, n_u=30, n_v=24, m=140)
    be = build_beindex(tg)
    m = tg.m
    rng = np.random.default_rng(seed)
    peeled = np.zeros(m, bool)
    peeled[rng.choice(m, size=m // 6, replace=False)] = True
    nb = max(be.nb, 1)
    sup0 = be.edge_support(m).astype(np.int32)
    links = [torch.from_numpy(x) for x in (be.link_edge, be.link_twin,
                                           be.link_bloom)]
    got = tpeel._wing_update(
        torch.from_numpy(peeled), torch.ones(be.n_links, dtype=torch.bool),
        torch.from_numpy(be.bloom_k.copy()), torch.from_numpy(sup0), *links,
        nb, m)
    want = jpeel._wing_update(
        jnp.asarray(peeled), jnp.ones(be.n_links, bool),
        jnp.asarray(be.bloom_k), jnp.asarray(sup0),
        *(jnp.asarray(x.numpy()) for x in links), nb, m)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    packed = ops.pack_blooms(be.link_edge, be.link_twin, be.link_bloom, be.nb)
    k_alive = torch.zeros(packed["nb_pad"])
    k_alive[: be.nb] = torch.from_numpy(be.bloom_k.astype(np.float32))
    loss, c, _ = ops.bloom_update(
        torch.from_numpy(np.append(peeled, False)),
        torch.from_numpy(packed["valid"]), k_alive,
        *(torch.from_numpy(packed[k]) for k in ("le", "lt", "canon")))
    assert torch.equal(torch.from_numpy(sup0) - loss.to(torch.int32), got[2])
    assert torch.equal(c[: be.nb].to(torch.int32),
                       torch.from_numpy(be.bloom_k) - got[1])


@pytest.mark.parametrize("batch_recount", [True, False, "adaptive"])
@pytest.mark.parametrize("seed,P", [(11, 2), (205, 4)])
def test_dense_tip_batch_recount_equals_reference(batch_recount, seed, P):
    jg, tg = _graph_pair(seed)
    for side in ("u", "v"):
        want = jpeel.tip_decomposition(jg, side=side, P=P, engine="dense",
                                       batch_recount=batch_recount)
        np.testing.assert_array_equal(want.theta,
                                      core_ref.bup_tip_ref(jg, side))
        got = tpeel.tip_decomposition(tg, side=side, P=P, engine="dense",
                                      batch_recount=batch_recount,
                                      device="cpu")
        assert _snapshot(got) == _snapshot(want), side


@pytest.mark.parametrize("seed,P", [(11, 2), (4096, 5)])
def test_wing_engines_equal_reference_and_oracle(seed, P):
    jg, tg = _graph_pair(seed, m=70)
    oracle = core_ref.bup_wing_ref(jg)
    for engine in ("beindex", "dense"):
        want = jpeel.wing_decomposition(jg, P=P, engine=engine)
        np.testing.assert_array_equal(want.theta, oracle)
        got = tpeel.wing_decomposition(tg, P=P, engine=engine, device="cpu")
        assert _snapshot(got) == _snapshot(want), engine
    # an injected ⋈init (the --edges path's) changes nothing
    sup0 = build_beindex(tg).edge_support(tg.m)
    got = tpeel.wing_decomposition(tg, P=P, engine="dense", sup0=sup0,
                                   device="cpu")
    assert _snapshot(got) == _snapshot(want)


def test_be_index_injection_changes_nothing():
    jg, tg = _graph_pair(3)
    be = build_beindex(tg)
    a = tpeel.wing_decomposition(tg, P=3, be=be, device="cpu")
    b = tpeel.wing_decomposition(tg, P=3, device="cpu")
    assert a.stats.engine == "beindex"
    assert _snapshot(a) == _snapshot(b)


# (graph, P) for the beindex FD phase: the goldens' graphs at several P
# (P 1: CD leaves one partition, as on the benchmark's bcl-943), and a
# sparse graph whose partition 0 holds no twin pair (its edges have no
# butterfly), so that partition runs no round
BE_FD_GRAPHS = dict(GRAPHS, sparse30=lambda: tgraph.random_bipartite(
    30, 24, 60, seed=0))
BE_FD_CASES = ([(g, P) for g in sorted(GRAPHS) for P in (1, 2, 4, 16)]
               + [("sparse30", 3)])


def _wing_pair(name):
    tg = BE_FD_GRAPHS[name]()
    return JGraph(tg.n_u, tg.n_v, tg.edges.copy()), tg


@pytest.mark.parametrize("name,P", BE_FD_CASES,
                         ids=[f"{g}-P{P}" for g, P in BE_FD_CASES])
def test_beindex_fd_equals_reference(name, P):
    """θ, every stat and every FD timeline row (k, died, frontier,
    updates) of the beindex engine equal the JAX package's."""
    jg, tg = _wing_pair(name)
    try:
        tobs.enable()
        got = tpeel.wing_decomposition(tg, P=P, device="cpu")
        jobs.enable()
        want = jpeel.wing_decomposition(jg, P=P)
    finally:
        tobs.disable()
        jobs.disable()
    assert _snapshot(got) == _snapshot(want)
    np.testing.assert_array_equal(got.theta, core_ref.bup_wing_ref(jg))
    assert len(got.timeline.fd) == len(want.timeline.fd) > 0
    for a, b in zip(got.timeline.fd, want.timeline.fd):
        for key in ("mode", "parts", "rounds", "truncated"):
            assert a[key] == b[key], key
        for key in ("k", "died", "frontier", "updates"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    s = got.stats
    if P == 1:
        assert s.p_effective == 1 and s.rho_fd_total == s.rho_fd_max > 0
    if name == "sparse30":
        per = {}
        st = tspec.PeelStats()
        spec = tpeel.build_peel_spec(tg, "wing", st, engine="beindex",
                                     device="cpu")
        part, sup_init, _, n = tspec.cd_loop(spec, P, st)
        tspec.run_fd(spec, part, sup_init, np.zeros(tg.m, np.int64), n, st,
                     per_partition=per)
        assert per[0] == (0, 0, 0) and (part == 0).any()
        assert sum(v[0] for v in per.values()) == s.rho_fd_total > 0


@pytest.mark.parametrize("name,P,only", [("pl80", 16, [4, 0, 2]),
                                         ("sparse30", 3, [0]),
                                         ("rb30", 4, [1])])
def test_beindex_fd_only_subset_equals_reference(name, P, only):
    """``run_fd(only=...)`` peels just those partitions: θ (0 elsewhere),
    each partition's (rounds, updates, recounts) and the stats equal the
    JAX package's."""
    jg, tg = _wing_pair(name)
    out = []
    for spec_mod, peel_mod, g, kw in ((tspec, tpeel, tg, dict(device="cpu")),
                                      (jspec, jpeel, jg, {})):
        st = spec_mod.PeelStats()
        spec = peel_mod.build_peel_spec(g, "wing", st, engine="beindex", **kw)
        part, sup_init, _, n = spec_mod.cd_loop(spec, P, st)
        assert n > max(only)
        theta, per = np.zeros(g.m, np.int64), {}
        spec_mod.run_fd(spec, part, sup_init, theta, n, st, only=only,
                        per_partition=per)
        out.append((theta, per, st.as_dict(), part))
    (t_theta, t_per, t_st, part), (j_theta, j_per, j_st, _) = out
    np.testing.assert_array_equal(t_theta, j_theta)
    assert not t_theta[~np.isin(part, only)].any()
    assert t_per == j_per and sorted(t_per) == sorted(only)
    assert t_st == j_st


@pytest.mark.parametrize("seed,tau", [(5, 0.25), (9, 0.5)])
def test_bepc_baseline_equals_reference(seed, tau):
    jg, tg = _graph_pair(seed)
    want_theta, want_stats = jpeel.wing_decomposition_bepc(jg, tau=tau)
    got_theta, got_stats = tpeel.wing_decomposition_bepc(tg, tau=tau,
                                                         device="cpu")
    np.testing.assert_array_equal(got_theta, want_theta)
    np.testing.assert_array_equal(got_theta, core_ref.bup_wing_ref(jg))
    assert got_stats.as_dict() == want_stats.as_dict()
    assert tpeel.bup_levels(got_theta) == jpeel.bup_levels(want_theta)


def test_dense_guard_raises_memory_error(monkeypatch):
    g = tgraph.random_bipartite(30, 24, 140, seed=0)
    monkeypatch.setenv("REPRO_DENSE_MAX_ELEMS", "500")
    for kind in ("tip", "wing"):
        fn = (tpeel.tip_decomposition if kind == "tip"
              else tpeel.wing_decomposition)
        with pytest.raises(MemoryError, match="REPRO_DENSE_MAX_ELEMS=500"):
            fn(g, engine="dense", device="cpu")
    # the csr and beindex engines take no dense matrices
    tpeel.tip_decomposition(g, engine="csr", device="cpu")
    tpeel.wing_decomposition(g, engine="beindex", device="cpu")


def _load(name, path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_engine_phase_rehearsed_on_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 8 on the CPU at a small size: the
    recorder's own ``record`` (the JAX package) writes the values for a
    small dense and wing graph, and the phase holds the port to them with
    the plain versions of the kernels (so no launches here)."""
    import copy

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smoke = _load("chip_smoke", os.path.join(root, "chip_smoke.py"))
    rec = _load("record_torch_engines", os.path.join(
        root, "tests", "goldens", "record_torch_engines.py"))
    dense_kw = dict(n_u=300, n_v=260, m=2500, alpha=0.6, seed=0)
    wing_kw = dict(n_u=120, n_v=60, m=900, alpha=0.6, seed=0)
    engines = rec.record(dense_kw, wing_kw, with_dense=True,
                         log=lambda msg: None)
    jg = rec.powerlaw_bipartite(**wing_kw)
    fullsize = {"wing-60k": dict(graph=wing_kw, P=rec.P, **rec.snapshot(
        jpeel.wing_decomposition(jg, P=rec.P, engine="csr")))}
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, reps: fn() and 0.0)
    launches = {}
    rows, seconds = smoke.phase_engines(engines, fullsize, "cpu", launches)
    assert set(rows) == {"vertex_count", "vertex_count_tile", "matmul",
                         "bloom_update", "fd_tip_dense", "fd_wing_beindex"}
    assert all(r["max_abs_err"] == 0.0 for r in rows.values())
    assert launches and not any(launches.values())
    assert {"dense-16k --kind tip --engine dense", "wing-60k --kind wing",
            "wing-60k --kind wing --engine dense"} <= set(seconds)
    # a wrong recorded value is caught
    bad = copy.deepcopy(engines["wing-60k"])
    bad["index"]["nb"] += 1
    g = tgraph.powerlaw_bipartite(**wing_kw)
    with pytest.raises(AssertionError, match="BE-Index"):
        smoke.check_bloom_rounds(bad, g, "cpu", {}, {})
