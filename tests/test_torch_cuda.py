"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``); the ``card``
fixture skips them where ``torch.cuda.is_available()`` is False.  The
file imports no JAX (the card's machine has none): inputs come from the
port's own packers on small graphs, and the BE-Index build is held to the
JAX package's index as recorded in ``tests/goldens/torch_beindex.json``
and ``torch_engines.json``.  Run on a machine with a card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import counting, csr, peel, peelspec
from repro_torch.core.beindex import build_beindex
from repro_torch.core.fdpack import (pack_fd_partitions_csr,
                                     pack_fd_partitions_tip_csr)
from repro_torch.core.graph import (BipartiteGraph, powerlaw_bipartite,
                                   random_bipartite)
from repro_torch.kernels import _build, flash_attention, ops, ref
from repro_torch.kernels.bloom_update import bloom_update
from repro_torch.kernels.butterfly_count import (matmul, pack_s8,
                                                 vertex_count,
                                                 vertex_count_tile)
from repro_torch.kernels.support_update import support_update
from repro_torch.kernels.wedge_count import wedge_count, wedge_count_tile

pytestmark = pytest.mark.cuda

GRAPHS = {
    "rb30": lambda: random_bipartite(30, 24, 140, seed=0),
    "pl80": lambda: powerlaw_bipartite(80, 40, 350, seed=2),
    "pl800": lambda: powerlaw_bipartite(800, 400, 6000, alpha=0.6, seed=0),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


def _cd(g, kind, wed, dev):
    stats = peelspec.PeelStats()
    spec = peel.build_peel_spec(g, kind, stats, wed=wed, device=dev)
    part, sup_init, _, n = peelspec.cd_loop(spec, 4, stats)
    return part, sup_init, n


def _iterate(state, statics, kernel, plain):
    sk = tuple(t.clone() for t in state)
    sp = state
    rounds = 0
    while bool(sk[1].any()):
        want = plain(*sp, *statics)
        kernel(*sk, *statics)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(sk, want)):
            assert torch.equal(a, b), (rounds, i)
        sp = want
        rounds += 1
    return rounds


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_fd_round_wing_kernel_equals_plain(card, gname):
    g = GRAPHS[gname]()
    wed = csr.build_wedges(g)
    part, sup_init, n = _cd(g, "wing", wed, card)
    p = pack_fd_partitions_csr(wed, part, sup_init, n, bucket=True,
                               slots=True)
    s = ops.state_from_numpy(p, card)
    state = (*peel._fused_state(s["mine"], s["sup0"], 3),
             s["slot_valid"].to(torch.int32),
             torch.from_numpy(peel._w_rows(p, n)).to(card, torch.float32))
    before = ops.launch_counts()["fd_round_wing"]
    rounds = _iterate(state, (s["slot_e1"], s["slot_e2"]),
                      ops.fd_round_wing, ref.fd_round_wing_ref)
    assert rounds > 0
    assert ops.launch_counts()["fd_round_wing"] - before == rounds


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_fd_round_tip_kernel_equals_plain(card, gname):
    g = GRAPHS[gname]()
    wed = csr.build_wedges(g)
    part, sup_init, n = _cd(g, "tip", wed, card)
    p = pack_fd_partitions_tip_csr(wed, wed.pair_butterflies0(), part,
                                   sup_init, n, bucket=True, stacked=True)
    s = ops.state_from_numpy(p, card)
    state = peel._fused_state(s["mine"], s["sup0"], 2)
    assert _iterate(state, (s["st_pa"], s["st_pb"], s["st_bf"]),
                    ops.fd_round_tip, ref.fd_round_tip_ref) > 0


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_support_update_and_wedge_count_kernels_equal_plain(card, gname):
    g = GRAPHS[gname]()
    wed = csr.build_wedges(g)
    slots = csr.pack_update_slots(wed)
    rng = np.random.default_rng(0)
    pe = torch.from_numpy(np.append(rng.random(g.m) < 0.2, False)).to(card)
    e1 = torch.from_numpy(slots["e1"]).to(card)
    e2 = torch.from_numpy(slots["e2"]).to(card)
    alive = torch.from_numpy(slots["valid"]).to(card, torch.float32)
    W = alive.sum(dim=1)
    args = (pe[e1].float(), pe[e2].float(), alive, W)
    for a, b in zip(support_update(*args), ref.support_update_ref(*args)):
        assert torch.equal(a, b)
    for a, b in zip(wedge_count(alive), ref.pair_wedge_counts_ref(alive)):
        assert torch.equal(a, b)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    x = torch.zeros((4, 128), device=card)
    with pytest.raises(TypeError):
        wedge_count(x.to(torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        wedge_count(torch.zeros((128, 4), device=card).t())
    with pytest.raises(ValueError, match="on cpu"):
        support_update(x, x, x, torch.zeros(4))


def test_golden_cells_with_fused_kernels(card):
    with open(os.path.join(os.path.dirname(__file__), "goldens",
                           "peel_goldens.json")) as f:
        goldens = json.load(f)
    g = GRAPHS["pl80"]()
    for key in ("wing.pl80.P6.csr.device", "wing.pl80.P6.csr.vmapped",
                "tip.pl80.P6.u.csr.device", "tip.pl80.P6.v.csr.vmapped"):
        parts = key.split(".")
        kw = dict(P=6, engine="csr", fd_driver=parts[-1], fused=True,
                  device=card)
        res = (peel.wing_decomposition(g, **kw) if parts[0] == "wing"
               else peel.tip_decomposition(g, side=parts[3], **kw))
        assert res.theta.tolist() == goldens[key]["theta"], key
        assert res.stats.rho_fd_total == goldens[key]["rho_fd_total"], key
        assert res.stats.updates == goldens[key]["updates"], key


def _tile_slots(rng, n_rows, width, hub_rows=4):
    """Seeded int32 0/1 slot rows: sparse rows, a few full (hub) rows."""
    slots = (rng.random((n_rows, width)) < 0.05).astype(np.int32)
    slots[rng.choice(n_rows, size=min(hub_rows, n_rows), replace=False)] = 1
    return slots


@pytest.mark.parametrize("n_rows,width", [(1, 512), (37, 512), (1000, 512),
                                          (300, 64), (50, 3), (129, 5)])
def test_wedge_count_tile_kernel_equals_plain(card, n_rows, width):
    slots = _tile_slots(np.random.default_rng(n_rows), n_rows, width)
    t = torch.from_numpy(slots).to(card)
    # padded as the tiled init pads: bucketed rows, rows below n unread
    padded = torch.zeros((ops._row_bucket(n_rows, 8) + 8, width),
                         dtype=torch.int32, device=card)
    padded[:n_rows] = t
    padded[n_rows:] = 7   # never read by the kernel
    before = ops.launch_counts()["wedge_count_tile"]
    got = wedge_count_tile(padded, n_rows)
    torch.cuda.synchronize()
    assert ops.launch_counts()["wedge_count_tile"] - before == 1
    assert torch.equal(got, ref.tile_row_counts_ref(t))
    assert got.tolist() == slots.sum(axis=1).tolist()
    # a matrix off the 16-byte boundary takes the scalar loads
    buf = torch.zeros(n_rows * width + 1, dtype=torch.int32, device=card)
    view = buf[1:].view(n_rows, width)
    view.copy_(t)
    assert torch.equal(wedge_count_tile(view), ref.tile_row_counts_ref(t))


def test_wedge_count_tile_rejects_what_the_kernel_does_not_take(card):
    x = torch.zeros((8, 128), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        wedge_count_tile(x.float())
    with pytest.raises(ValueError, match="contiguous"):
        wedge_count_tile(torch.zeros((128, 8), dtype=torch.int32,
                                     device=card).t())
    with pytest.raises(ValueError, match="outside"):
        wedge_count_tile(x, 9)


@pytest.mark.parametrize("tile_wedges,width", [(2000, 512), (700, 64)])
def test_tiled_init_kernel_route_equals_host_path(card, tile_wedges, width):
    g = GRAPHS["pl800"]()
    host = csr.tiled_butterfly_init(g, tile_wedges=tile_wedges)
    before = ops.launch_counts()["wedge_count_tile"]
    dev = csr.tiled_butterfly_init(g, tile_wedges=tile_wedges,
                                   use_pallas=True, width=width, device=card)
    assert np.array_equal(dev[0], host[0]) and np.array_equal(dev[1], host[1])
    assert dev[2] == host[2] and dev[3].n_tiles == host[3].n_tiles > 1
    assert dev[3].peak_slot_bytes > 0
    assert ops.launch_counts()["wedge_count_tile"] - before == dev[3].n_tiles


def test_hierarchy_and_service_on_the_card_equal_the_cpu(card):
    from repro_torch.hierarchy import (HierarchyService, build_hierarchy,
                                       lca_entities, subgraph_at)
    from repro_torch.hierarchy.serialize import _ARRAY_FIELDS

    g = GRAPHS["pl800"]()
    for kind in ("wing", "tip"):
        fn = peel.wing_decomposition if kind == "wing" else \
            peel.tip_decomposition
        res = fn(g, P=8, engine="csr", device="cpu")
        hc = build_hierarchy(g, res, kind=kind, device="cpu")
        hg = build_hierarchy(g, res, kind=kind, device=card)
        for f in _ARRAY_FIELDS:
            assert np.array_equal(getattr(hg, f), getattr(hc, f)), (kind, f)
        rng = np.random.default_rng(0)
        n = 3000
        ops_ = rng.integers(0, 5, n).astype(np.int32)
        a = np.where(ops_ == 4, rng.integers(0, hc.n_nodes, n),
                     rng.integers(0, hc.n_entities, n)).astype(np.int32)
        b = rng.integers(0, hc.n_entities, n).astype(np.int32)
        sc = HierarchyService(hc, device="cpu")
        sg = HierarchyService(hc, device=card)
        assert np.array_equal(sg.query_batch(ops_, a, b),
                              sc.query_batch(ops_, a, b))
        nodes = np.arange(hc.n_nodes)
        assert np.array_equal(sg.subgraph_masks(nodes),
                              sc.subgraph_masks(nodes))
        assert torch.equal(lca_entities(sg.forest, a, b).cpu(),
                           lca_entities(sc.forest, a, b))
        assert torch.equal(subgraph_at(sg.forest, [0]).cpu(),
                           subgraph_at(sc.forest, [0]))


def _launched(name, fn):
    before = ops.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts()[name] - before


def tf32x3_bound(a, b):
    """Elementwise bound on |C − a·b| of the 3xTF32 ``matmul`` (``b`` is
    [K, N]): γ Σ_k |a_ik||b_kj|, γ = (3·2⁻²² + 108·2⁻²³ + ⌈K/32⌉·2⁻²⁴)
    (1 + 2⁻⁸).  The split drops lo·lo and rounds each lo to TF32, 2⁻²²
    each.  A 32-deep k tile runs twelve k8 wgmma steps, each rounded
    toward zero; how the tensor cores align a step's eight products is
    not documented, so each step may lose 2⁻²³ of each of its nine
    addends.  Each tile sum joins the running sum by one rounded f32 add
    (2⁻²⁴).  The last factor covers second-order terms."""
    k = a.shape[1]
    gamma = ((3 * 2.0 ** -22 + 108 * 2.0 ** -23 + math.ceil(k / 32) * 2.0 ** -24)
             * (1 + 2.0 ** -8))
    return gamma * (a.double().abs() @ b.double().abs())


# ragged on purpose: n off the 128-row tiles and 256-column squares
# (n = 1 and 2 100 > 8 squares: a band's triangle and the squares right
# of it), k off the 16-byte pitch and the 128-deep k tiles
@pytest.mark.parametrize("n_u,n_v,m", [(40, 30, 200), (130, 70, 700),
                                       (257, 129, 1500), (300, 500, 6000),
                                       (1, 17, 10), (513, 1000, 20000),
                                       (2100, 300, 30000)])
def test_vertex_count_kernels_equal_plain(card, n_u, n_v, m):
    g = random_bipartite(n_u, n_v, m, seed=n_u + m)
    A = torch.from_numpy(g.adjacency()).to(card)
    # unpadded: TMA zero-fills the ragged edges
    got, n = _launched("vertex_count", lambda: vertex_count(A))
    assert n == 1 and torch.equal(got, ref.vertex_butterflies_ref(A))
    assert torch.equal(ops.vertex_butterflies(A),
                       counting.vertex_butterflies(A))
    A8 = pack_s8(A)
    assert torch.equal(A8, ref.pack_s8_ref(A)[0])
    assert torch.equal(vertex_count(A8), got)
    for r0, r1 in ((0, n_u), (3, min(n_u, 131))):
        strip = A[r0:r1].contiguous()
        got, n = _launched("vertex_count_tile",
                           lambda: vertex_count_tile(strip, A))
        assert n == 1
        assert torch.equal(got, ref.vertex_count_tile_ref(strip, A))
        # a strip as a row slice of the packed matrix
        assert torch.equal(vertex_count_tile(A8[r0:r1], A8), got)
    packs = _build.LAUNCHES["pack_s8"]
    tiled, n = _launched("vertex_count_tile",
                         lambda: ops.vertex_butterflies_tiled(A, 128))
    assert n == -(-n_u // 128)
    assert _build.LAUNCHES["pack_s8"] - packs == 1  # A is packed once
    assert torch.equal(tiled, counting.vertex_butterflies(A))


def _portbench_graph(name):
    """(n_u, n_v, edges) of a benchmark configuration for the run seed
    2**31 + 11 (``portbench/graphgen.py``, NumPy only)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import graphgen

    with open(os.path.join(root, "portbench", "configs",
                           f"{name}.json")) as f:
        return graphgen.make_graph(json.load(f), 2**31 + 11)


def test_vertex_count_is_int64_exact_past_2_24(card):
    """The kernel's int64 counts equal NumPy's where float32 cannot hold
    them: the CPU tests' dense graph (every count past 2**24, many odd)
    and the benchmark's bcl-6040 graph (17 users past 2**24)."""
    from test_torch_dense_exact import dense_graph, numpy_counts

    A_np, _ = dense_graph()
    n_u, n_v, edges = _portbench_graph("bcl-6040")
    A6 = np.zeros((n_u, n_v), dtype=np.float32)
    A6[edges[:, 0], edges[:, 1]] = 1.0
    # the bcl-6040 count in float64 BLAS (W's entries are exact there),
    # then C(W, 2) and the sums in int64
    W6 = A6.astype(np.float64) @ A6.T.astype(np.float64)
    np.fill_diagonal(W6, 0)
    W6 = W6.astype(np.int64)
    want6 = (W6 * (W6 - 1) // 2).sum(axis=1)
    del W6
    assert int((want6 >= 2 ** 24).sum()) == 17
    for A, want in ((A_np.astype(np.float32), numpy_counts(A_np)),
                    (A6, want6)):
        At = torch.from_numpy(A).to(card)
        got, n = _launched("vertex_count", lambda: ops.vertex_butterflies(At))
        assert n == 1 and got.dtype == torch.int64
        assert np.array_equal(got.cpu().numpy(), want)
        assert np.array_equal(
            ops.vertex_butterflies_tiled(At, 1024).cpu().numpy(), want)


def test_dense_tip_on_the_card_is_exact_past_2_24(card):
    """The dense tip engine on the card: ⋈init from the kernel, the pair
    cascades in float64, θ equal to the plain reference's."""
    from test_torch_dense_exact import (N_U, N_V, dense_graph,
                                        fd_initial_supports, pair_matrix)

    from portbench.reference import tip as ref_tip

    A, g = dense_graph()
    edges = np.argwhere(A).astype(np.int64)
    want = ref_tip.tip_numbers(N_U, N_V, edges)
    C = pair_matrix(A)
    for batch_recount in ("adaptive", True, False):
        res, n = _launched("vertex_count", lambda: peel.tip_decomposition(
            g, side="u", P=16, engine="dense", batch_recount=batch_recount,
            device=card))
        assert n == 1 + res.stats.recounts
        assert np.array_equal(np.asarray(res.support_init, np.int64),
                              fd_initial_supports(C, res.part))
        assert np.array_equal(np.asarray(res.theta, np.int64), want)


@pytest.mark.parametrize("P,empty", [(1, False), (3, False), (16, False),
                                     (16, True)])
def test_fd_tip_dense_kernel_equals_plain(card, P, empty):
    """The dense tip FD kernel against its plain version on supports past
    2**24: θ, each partition's rounds and every round's record, with one
    launch for all partitions (``empty``: partition 1 has no vertex)."""
    from test_torch_dense_exact import (N_U, dense_graph,
                                        fd_initial_supports, pair_matrix)

    A, _ = dense_graph()
    part = np.random.default_rng(P).integers(0, P, N_U)
    if empty:
        part[part == 1] = 0
    sup = fd_initial_supports(pair_matrix(A), part)
    order = np.argsort(part, kind="stable")
    off = np.concatenate([[0], np.cumsum(np.bincount(part, minlength=P))])
    args = (torch.from_numpy(order.astype(np.int32)), torch.from_numpy(off),
            torch.from_numpy(sup[order]))
    pair = peel._pair_butterflies(torch.from_numpy(A.astype(np.float32)))
    want = ops.fd_tip_dense(pair, *args)
    got, n = _launched("fd_tip_dense", lambda: ops.fd_tip_dense(
        pair.to(card), *(t.to(card) for t in args)))
    assert n == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)


def _bcl943_graph():
    """The benchmark's bcl-943 graph (``portbench/configs/bcl-943.json``'s
    ``generate`` block, unrelabelled): 943 × 1 682 drawn at 100 000
    edges, alpha 0.6, seed 0, then 560 users kept (seed 0) with all their
    edges; CD at P 16 leaves it one partition."""
    g = powerlaw_bipartite(943, 1682, 100000, alpha=0.6, seed=0)
    kept = np.sort(np.random.default_rng(0).choice(943, size=560,
                                                   replace=False))
    new_id = np.full(943, -1, dtype=np.int64)
    new_id[kept] = np.arange(560)
    e = g.edges[new_id[g.edges[:, 0]] >= 0]
    return BipartiteGraph.from_edges(
        560, 1682, np.stack([new_id[e[:, 0]], e[:, 1]], 1))


# (graph, P, partitions CD leaves): bcl-943's one partition, and seeded
# skewed graphs with many
FD_WING_BE_GRAPHS = {
    "bcl943": (_bcl943_graph, 16, 1),
    "pl3k": (lambda: powerlaw_bipartite(3000, 2000, 40000, alpha=0.6,
                                        seed=1), 16, None),
    "pl800": (GRAPHS["pl800"], 32, None),
}


@pytest.mark.parametrize("gname", sorted(FD_WING_BE_GRAPHS))
def test_fd_wing_beindex_kernel_equals_plain(card, gname):
    """The beindex FD kernel against its plain version on the pack of a
    CD run on the card: θ, each partition's rounds and updates and every
    round's record, with one launch for all partitions."""
    make, P, n_parts = FD_WING_BE_GRAPHS[gname]
    g = make()
    stats = peelspec.PeelStats()
    spec = peel.build_peel_spec(g, "wing", stats, engine="beindex",
                                device=card)
    part, sup_init, _, n = peelspec.cd_loop(spec, P, stats)
    assert n == n_parts if n_parts else n > 4
    be = build_beindex(g, card)
    le, lt, lb = peel._wing_links(be, card)
    args = peel._wing_fd_pack(le, lt, lb, be.nb, part, sup_init)
    want = ref.fd_wing_beindex_ref(*args)
    got, launches = _launched("fd_wing_beindex",
                              lambda: ops.fd_wing_beindex(*args))
    assert launches == 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got[1].sum()) > n


@pytest.mark.parametrize("gname", ["pl3k", "pl800"])
def test_wing_beindex_decomposition_reads_the_card_once(card, gname):
    """A whole beindex wing decomposition on the card launches one
    ``fd_wing_beindex`` and reads its FD results once (``fd.host_syncs``
    1), and gives the CPU run's θ and stats."""
    make, P, _ = FD_WING_BE_GRAPHS[gname]
    g = make()
    want = peel.wing_decomposition(g, P=P, device="cpu")
    before, syncs = ops.launch_counts(), obs.counts().get("fd.host_syncs", 0)
    got = peel.wing_decomposition(g, P=P, device=card)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in ops.KERNELS} == {
        k: int(k == "fd_wing_beindex") for k in ops.KERNELS}
    assert obs.counts()["fd.host_syncs"] - syncs == 1
    assert got.stats.p_effective > 1
    np.testing.assert_array_equal(got.theta, want.theta)
    assert got.stats.as_dict() == want.stats.as_dict()


@pytest.mark.parametrize("bad", [2.0, 0.5, -1.0, float("nan")])
def test_vertex_count_kernels_refuse_non_binary_input(card, bad):
    A = torch.from_numpy(random_bipartite(70, 40, 300, seed=1).adjacency())
    A = A.to(card)
    A[5, 7] = bad
    before = ops.launch_counts()
    for call in (lambda: vertex_count(A), lambda: vertex_count_tile(A[:9], A),
                 lambda: ops.vertex_butterflies(A),
                 lambda: ops.vertex_butterflies_tiled(A, 128),
                 lambda: pack_s8(A)):
        with pytest.raises(ValueError, match="0/1 adjacency"):
            call()
    assert ops.launch_counts() == before  # refused before any product


@pytest.mark.parametrize("M,N,K", [(1, 1, 1), (70, 257, 33), (128, 128, 128),
                                   (300, 129, 1000)])
@pytest.mark.parametrize("trans_b", [False, True])
def test_matmul_kernel_equals_plain(card, M, N, K, trans_b):
    rng = np.random.default_rng(M + N + K)
    a = torch.from_numpy(rng.integers(0, 40, (M, K)).astype(np.float32))
    b = torch.from_numpy(rng.integers(0, 40, (N, K) if trans_b else (K, N))
                         .astype(np.float32))
    a, b = a.to(card), b.to(card)
    got, n = _launched("matmul", lambda: matmul(a, b, trans_b))
    assert n == 1 and torch.equal(got, ref.matmul_ref(a, b, trans_b))


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("M,N,K", [(1000, 777, 1333), (129, 1001, 4099)])
def test_matmul_3xtf32_at_ragged_shapes(card, M, N, K, trans_b):
    """Equal to the plain (full-f32) version on 0/1 and integer inputs,
    with no lo plane, with a lo plane in one operand (integers to 3 000
    against 0/1), and within ``tf32x3_bound`` and relative 1e-5 of an f64
    product on random f32 (normal and uniform; both lo planes): the
    kernel's 3xTF32 split, its skipped planes and per-tile f32 sums."""
    rng = np.random.default_rng(M + N + K)
    shape_b = (N, K) if trans_b else (K, N)
    # 0/1, integers below 50, then a lo plane in a or in b; every sum
    # stays an integer below 2^24
    for tops in ((2, 2), (50, 50), (3000, 2), (2, 3000)):
        a, b = (torch.from_numpy(rng.integers(0, t, s).astype(np.float32))
                .to(card) for t, s in zip(tops, ((M, K), shape_b)))
        got, n = _launched("matmul", lambda: matmul(a, b, trans_b))
        assert n == 1 and torch.equal(got, ref.matmul_ref(a, b, trans_b))
    g = torch.Generator(device=card).manual_seed(K)
    for draw in (torch.randn, torch.rand):
        a, b = (draw(s, generator=g, device=card) for s in ((M, K), shape_b))
        b_kn = b.T if trans_b else b
        exact = a.double() @ b_kn.double()
        err = (matmul(a, b, trans_b).double() - exact).abs()
        assert (err <= tf32x3_bound(a, b_kn)).all()
        assert (err.norm() / exact.norm()).item() <= 1e-5


def test_matmul_a_at_shares_the_planes_of_a(card):
    """``a @ aᵀ`` (the count's first product) passes one tensor twice; its
    planes are split once and the result is unchanged."""
    a = (torch.rand((300, 500), device=card) < 0.1).float()
    assert torch.equal(matmul(a, a, True), matmul(a, a.clone(), True))
    assert torch.equal(matmul(a, a, True), ref.matmul_ref(a, a, True))


@pytest.mark.parametrize("n_u,n_v,m", [(50, 40, 260), (200, 100, 1100)])
def test_edge_wedge_matrix_on_the_card(card, n_u, n_v, m):
    g = random_bipartite(n_u, n_v, m, seed=m)
    A = torch.from_numpy(g.adjacency()).to(card)
    got, n = _launched("matmul", lambda: ops.edge_wedge_matrix(A))
    assert n == 2 and torch.equal(got, ref.edge_wedge_matrix_ref(A))
    e = torch.from_numpy(g.edges).to(card, torch.int64)
    du = A.sum(1)
    assert torch.equal(got[e[:, 0], e[:, 1]] - (du[e[:, 0]] - 1),
                       counting.edge_butterflies(A, e))


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_bloom_update_kernel_equals_plain(card, gname, frac):
    g = GRAPHS[gname]()
    be = build_beindex(g)
    p = ops.pack_blooms(be.link_edge, be.link_twin, be.link_bloom, be.nb)
    rng = np.random.default_rng(1)
    peeled = torch.from_numpy(np.append(rng.random(g.m) < frac, False))
    peeled = peeled.to(card)
    le, lt, valid, canon = (torch.from_numpy(p[k]).to(card)
                            for k in ("le", "lt", "valid", "canon"))
    k_alive = torch.zeros(p["nb_pad"], device=card)
    k_alive[: be.nb] = torch.from_numpy(be.bloom_k).to(card, torch.float32)
    sent = g.m
    lei, lti = (torch.where(x < 0, sent, x) for x in (le, lt))
    flags = [ops._u8(x) for x in (peeled[lei], peeled[lti], valid, canon)]
    got, n = _launched("bloom_update", lambda: bloom_update(*flags, k_alive))
    assert n == 1
    for a, b in zip(got, ref.bloom_update_ref(*flags, k_alive)):
        assert torch.equal(a, b)
    # one ops round equals the engine's update
    sup0 = torch.from_numpy(be.edge_support(g.m).astype(np.int32)).to(card)
    loss, c, _ = ops.bloom_update(peeled, valid, k_alive, le, lt, canon)
    links = [torch.from_numpy(x).to(card)
             for x in (be.link_edge, be.link_twin, be.link_bloom)]
    _, k_l, sup_l, _ = peel._wing_update(
        peeled[: g.m], torch.ones(be.n_links, dtype=torch.bool, device=card),
        torch.from_numpy(be.bloom_k).to(card), sup0, *links,
        max(be.nb, 1), g.m)
    assert torch.equal(sup0 - loss.to(torch.int32), sup_l)
    assert torch.equal(k_alive[: be.nb].to(torch.int32) - c[: be.nb].to(
        torch.int32), k_l)


# the JAX package's BE-Index of small graphs, recorded with their edges by
# tests/goldens/record_torch_beindex.py (held to JAX by the CPU tests)
BE_GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                         "torch_beindex.json")
BE_ARRAYS = ("bloom_k", "link_edge", "link_twin", "link_bloom")


def _recorded_graph(name):
    """A ``torch_beindex.json`` graph, its edge rows in recorded order."""
    with open(BE_GOLDEN) as f:
        rec = json.load(f)[name]
    return rec, BipartiteGraph(rec["n_u"], rec["n_v"], np.asarray(
        rec["edges"], dtype=np.int32).reshape(-1, 2))


@pytest.mark.parametrize("name", ["numpy", "pl60", "pl80", "rb25", "rb30",
                                  "no_edges", "no_butterflies",
                                  "isolated_and_degree1", "tied_degrees",
                                  "unsorted_rows", "wing-60k"])
def test_build_beindex_on_the_card_equals_the_reference(card, name):
    """The build on the card (torch ops, no kernel launch): its nb and
    four arrays against the JAX package's index, recorded by the sha256
    of each array."""
    import hashlib

    if name == "wing-60k":
        with open(os.path.join(os.path.dirname(BE_GOLDEN),
                               "torch_engines.json")) as f:
            rec = json.load(f)["wing-60k"]
        g = powerlaw_bipartite(**rec["graph"])
    else:
        rec, g = _recorded_graph(name)
    before = ops.launch_counts()
    be = build_beindex(g, card)
    torch.cuda.synchronize()
    assert ops.launch_counts() == before
    got = dict(nb=be.nb, n_links=be.n_links)
    if "max_pairs" in rec["index"]:
        got["max_pairs"] = int(be.bloom_k.max())
    for k in BE_ARRAYS:
        a = getattr(be, k)
        assert isinstance(a, np.ndarray) and a.dtype == np.int32, k
        got[f"{k}_sha256"] = hashlib.sha256(a.tobytes()).hexdigest()
    assert got == rec["index"]


def test_new_wrappers_reject_what_the_kernels_do_not_take(card):
    x = torch.zeros((4, 128), device=card)
    with pytest.raises(TypeError):
        vertex_count(x.double())
    with pytest.raises(ValueError, match="shape"):
        vertex_count_tile(x, torch.zeros((4, 64), device=card))
    # packed operands: int8 rows of a multiple of 16, f32 and int8 not mixed
    with pytest.raises(ValueError, match="multiple of 16"):
        vertex_count(torch.zeros((4, 20), dtype=torch.int8, device=card))
    with pytest.raises(TypeError, match="both"):
        vertex_count_tile(x, pack_s8(x))
    with pytest.raises(ValueError, match="shape"):
        matmul(x, x)
    u8 = torch.zeros((4, 128), dtype=torch.uint8, device=card)
    with pytest.raises(TypeError):
        bloom_update(u8.bool(), u8, u8, u8, torch.zeros(4, device=card))
    # the kernel reads four slots at a time: odd K and a flag buffer off
    # the 4-byte boundary are refused
    odd = u8[:, :127].contiguous()
    with pytest.raises(ValueError, match="K % 4"):
        bloom_update(odd, odd, odd, odd, torch.zeros(4, device=card))
    off = torch.zeros(4 * 128 + 1, dtype=torch.uint8, device=card)[1:]
    with pytest.raises(ValueError, match="aligned"):
        bloom_update(off.view(4, 128), u8, u8, u8,
                     torch.zeros(4, device=card))


def test_engine_golden_cells_on_the_card(card):
    with open(os.path.join(os.path.dirname(__file__), "goldens",
                           "peel_goldens.json")) as f:
        goldens = json.load(f)
    g = GRAPHS["pl80"]()
    for key in ("wing.pl80.P6.beindex.device", "wing.pl80.P6.dense.device",
                "tip.pl80.P6.u.dense.device", "tip.pl80.P3.v.dense.device"):
        parts = key.split(".")
        kw = dict(P=int(parts[2][1:]), engine=parts[-2], device=card)
        res = (peel.wing_decomposition(g, **kw) if parts[0] == "wing"
               else peel.tip_decomposition(g, side=parts[3], **kw))
        assert res.theta.tolist() == goldens[key]["theta"], key
        for f in ("part", "support_init"):
            assert getattr(res, f).tolist() == goldens[key][f], (key, f)
        for f in ("updates", "recounts", "rho_fd_total"):
            assert getattr(res.stats, f) == goldens[key][f], (key, f)


# the kernel each (dtype, head dim) takes: the launch function's own
# route query (flash_attention_route), not a timing
def _route(dtype, d):
    if d == 32:
        return "cuda cores"
    return ("bf16 tensor cores" if dtype == torch.bfloat16
            else "3xtf32 tensor cores")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-3),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("qs,ks,causal,offset", [
    ((2, 8, 256, 128), (2, 2, 256, 128), True, None),   # GQA 4:1, D 128
    ((2, 8, 200, 64), (2, 1, 200, 64), True, None),     # MQA, ragged tail
    ((1, 4, 100, 256), (1, 4, 300, 256), False, None),  # D 256, non-causal
    ((2, 4, 64, 32), (2, 2, 192, 32), True, None),      # offset sk - sq
    ((2, 4, 96, 128), (2, 2, 160, 128), True, 0),       # explicit offset
    ((1, 2, 128, 64), (1, 2, 64, 64), True, None),      # rows that see no key
    ((2, 32, 512, 128), (2, 2, 512, 128), True, None),  # prefill-shaped, GQA 16:1
    ((2, 8, 384, 64), (2, 1, 384, 64), True, None),     # MQA, D 64
    ((1, 8, 320, 256), (1, 1, 320, 256), True, None),   # MQA, D 256
    ((1, 8, 4096, 256), (1, 1, 4096, 256), True, None),  # Gemma-2B at max_seq
    ((1, 4, 1500, 128), (1, 4, 1500, 128), False, None),  # ragged, non-causal
    ((1, 4, 700, 64), (1, 2, 1001, 64), False, None),   # ragged, sq != sk
    ((1, 4, 300, 256), (1, 2, 333, 256), False, None),  # ragged, D 256
    ((2, 8, 128, 128), (2, 2, 384, 128), True, None),   # offset: sq 128 < sk 384
    ((1, 4, 96, 256), (1, 2, 160, 256), True, 0),       # explicit offset, D 256
    ((1, 4, 160, 64), (1, 4, 160, 64), True, -40),      # rows 0-39 see no key
])
def test_flash_attention_kernel_matches_plain(card, dtype, atol, qs, ks,
                                              causal, offset):
    """Each dtype at each head dim takes its kernel (``_route``), one
    launch a call, within the JAX package's tolerance of the plain
    version and every row within ``F32_ROW_RTOL`` / ``BF16_ROW_RTOL``;
    rows that see no key are exactly 0."""
    assert flash_attention.route(dtype, qs[3]) == _route(dtype, qs[3])
    g = torch.Generator(device=card).manual_seed(qs[2] + ks[2])
    q, k, v = (torch.randn(s, generator=g, device=card).to(dtype)
               for s in (qs, ks, ks))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, offset=offset)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, offset=offset)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    assert _worst_row_rel(got, want) <= (
        F32_ROW_RTOL if dtype == torch.float32 else BF16_ROW_RTOL)
    if causal:
        off = ks[2] - qs[2] if offset is None else offset
        blind = torch.arange(qs[2], device=card) + off < 0
        assert not got[:, :, blind].any()


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_attention_kernel_reads_strided_heads(card, d):
    """The model's q/k/v are transposed views of [b, s, heads, d]: in
    f32, q through the 3×TF32 kernel's 4-D tensor map and k, v through
    its pre-pass (the CUDA-core kernel at D 32)."""
    g = torch.Generator(device=card).manual_seed(d + 1)
    x = torch.randn((2, 200, 8, d), generator=g, device=card)
    kv = torch.randn((2, 2, 200, 2, d), generator=g, device=card)
    q, k, v = x.transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2)
    assert not q.is_contiguous() and not v.is_contiguous()
    got = ops.flash_attention(q, k, v, causal=True, offset=0)
    want = ref.flash_attention_ref(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True, offset=0)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3)
    assert _worst_row_rel(got, want) <= F32_ROW_RTOL


@pytest.mark.parametrize("qs,ks,causal,offset", [
    ((2, 4, 256, 64), (2, 4, 256, 64), True, None),        # D 64
    ((2, 4, 256, 128), (2, 4, 256, 128), True, None),      # D 128
    ((2, 4, 256, 256), (2, 4, 256, 256), True, None),      # D 256
    ((1, 32, 384, 128), (1, 2, 384, 128), True, None),     # GQA 16:1
    ((2, 8, 320, 256), (2, 1, 320, 256), True, None),      # MQA, D 256
    ((1, 4, 1500, 128), (1, 4, 1500, 128), True, None),    # ragged S 1500
    ((1, 4, 1500, 64), (1, 2, 1500, 64), False, None),     # ragged, non-causal
    ((2, 8, 200, 128), (2, 8, 330, 128), False, None),     # non-causal, sq != sk
    ((2, 8, 128, 128), (2, 2, 384, 128), True, None),      # offset: sq 128 < sk 384
    ((1, 4, 192, 64), (1, 2, 128, 64), True, None),        # rows 0-63 see no key
    ((1, 4, 160, 256), (1, 4, 160, 256), True, -40),       # a negative offset
])
def test_flash_attention_bf16_tensor_cores_match_plain(card, qs, ks, causal,
                                                       offset):
    """The bf16 kernel (wgmma + TMA for D 64/128/256) against the plain
    version (f32 P) within 3e-2, the JAX package's bf16 tolerance, and
    every row within ``BF16_ROW_RTOL``; rows that see no key are exactly
    0."""
    g = torch.Generator(device=card).manual_seed(sum(qs) + sum(ks))
    q, k, v = (torch.randn(s, generator=g, device=card).bfloat16()
               for s in (qs, ks, ks))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, offset=offset)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, offset=offset)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=3e-2)
    assert _worst_row_rel(got, want) <= BF16_ROW_RTOL
    if causal:
        off = ks[2] - qs[2] if offset is None else offset
        blind = torch.arange(qs[2], device=card) + off < 0
        assert not got[:, :, blind].any()


# ‖Δ‖/‖ref‖ of one output row in bf16: P and the output are each rounded
# to bf16 once (2⁻⁹ relative); 1e-2 is five of those.  A row's typical
# value shrinks as it sees more keys, so an absolute tolerance alone
# would pass a wrong late row.
BF16_ROW_RTOL = 1e-2
# and in f32 (chip_smoke.py's gate; f32 rounds at 2⁻²⁴, the 3×TF32
# products keep about 2⁻²² of each term)
F32_ROW_RTOL = 1e-4


def _worst_row_rel(got, want) -> float:
    """max over the rows that see a key of ‖got_row − want_row‖ /
    ‖want_row‖."""
    d = (got.float() - want.float()).norm(dim=-1)
    n = want.float().norm(dim=-1)
    return (d[n > 0] / n[n > 0]).max().item()


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_bf16_reads_strided_heads(card, d):
    """The model's q/k/v in bf16: transposed views of [b, s, heads, d]
    read through 4-D tensor maps with those strides."""
    g = torch.Generator(device=card).manual_seed(d)
    x = torch.randn((2, 200, 8, d), generator=g, device=card).bfloat16()
    kv = torch.randn((2, 2, 200, 2, d), generator=g, device=card).bfloat16()
    q, k, v = x.transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2)
    assert not q.is_contiguous() and not v.is_contiguous()
    got = ops.flash_attention(q, k, v, causal=True, offset=0)
    want = ref.flash_attention_ref(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True, offset=0)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=3e-2)
    assert _worst_row_rel(got, want) <= BF16_ROW_RTOL


@pytest.mark.parametrize("sk,d", [(8, 64), (203, 128), (1001, 256)])
def test_split_kv_kernel_equals_plain(card, sk, d):
    """The 3×TF32 route's pre-pass, bit for bit its plain version (the
    planes, v transposed in ``ref.V_KEY_ORDER``, zero past Sk), on
    strided views; one launch a call."""
    g = torch.Generator(device=card).manual_seed(sk)
    kv = torch.randn((2, 2, sk, 3, d), generator=g, device=card)
    k, v = kv[0].transpose(1, 2), kv[1].transpose(1, 2)
    before = _build.LAUNCHES["split_kv"]
    got = flash_attention.split_kv(k, v)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["split_kv"] == before + 1
    for a, b in zip(got, ref.split_kv_ref(k.cpu(), v.cpu())):
        assert torch.equal(a.cpu(), b)


def test_flash_attention_routes(card):
    """The launch function's split: bf16 and f32 at D 64/128/256 on the
    tensor cores, D 32 on the CUDA cores, in both dtypes."""
    for d in (64, 128, 256):
        assert flash_attention.route(torch.bfloat16, d) == "bf16 tensor cores"
        assert flash_attention.route(torch.float32, d) == "3xtf32 tensor cores"
    for dt in (torch.float32, torch.bfloat16):
        assert flash_attention.route(dt, 32) == "cuda cores"
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.route(torch.float32, 48)


def test_flash_attention_refusals(card):
    q = torch.zeros((1, 2, 64, 64), device=card)
    with pytest.raises(TypeError, match="expected float32 or bfloat16"):
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="expected torch.float32"):
        ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="expected cuda"):
        ops.flash_attention(q, q.cpu(), q)
    # a head dim with no instance is padded (test_flash_attention_pads_
    # head_dims_without_an_instance); one above the largest raises
    big = torch.zeros((1, 2, 64, 320), device=card)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="multiple of KVH"):
        ops.flash_attention(q, q[:, :1].expand(1, 3, 64, 64).contiguous(), q)
    # a grad-requiring input is no longer refused: it takes the
    # autograd.Function (the kernel forward, the torch-ops backward)
    out = ops.flash_attention(q.clone().requires_grad_(), q, q)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-3),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("qs,dv,causal", [
    ((1, 8, 256, 192), 128, True),     # DeepSeek-V2's MLA: q/k 192, v 128
    ((2, 4, 200, 192), 128, True),     # MLA, ragged tail
    ((1, 4, 300, 192), 128, False),    # MLA, non-causal
    ((1, 4, 130, 48), 48, True),       # a head dim with no instance
    ((1, 4, 96, 96), 64, True),        # v narrower, padded to 128
    ((1, 32, 256, 112), 112, True),    # Zamba2's shared block: D 112
])
def test_flash_attention_pads_head_dims_without_an_instance(card, dtype, atol,
                                                            qs, dv, causal):
    """(D, Dv) that no instance takes: the wrapper zero-pads q, k and v
    to the next instance, launches it once and cuts the output to Dv;
    within the JAX package's tolerance of the plain version, every row
    within ``F32_ROW_RTOL`` / ``BF16_ROW_RTOL``.  v is a transposed view,
    as the model's is."""
    g = torch.Generator(device=card).manual_seed(qs[2] + dv)
    q, k = (torch.randn(qs, generator=g, device=card).to(dtype)
            for _ in range(2))
    vb = torch.randn((qs[0], qs[2], qs[1], dv), generator=g,
                     device=card).to(dtype)
    v = vb.transpose(1, 2)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v.contiguous(), causal=causal)
    assert got.dtype == dtype and got.shape == want.shape == (*qs[:3], dv)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    assert _worst_row_rel(got, want) <= (
        F32_ROW_RTOL if dtype == torch.float32 else BF16_ROW_RTOL)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-3),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("qs,ks", [
    ((2, 20, 1500, 64), (2, 20, 1500, 64)),   # Whisper's encoder (MHA)
    ((2, 20, 448, 64), (2, 20, 1500, 64)),    # cross-attention, prefill
    ((4, 20, 1, 64), (4, 20, 1500, 64)),      # cross-attention, decode
])
def test_flash_attention_at_whisper_shapes(card, dtype, atol, qs, ks):
    """Whisper's D 64 MHA at 20/20 heads, non-causal, over 1 500 frames,
    q and k/v transposed views of [b, s, heads, 64] as the model's: one
    launch, within the JAX package's tolerance of the plain version and
    every row within ``F32_ROW_RTOL`` / ``BF16_ROW_RTOL``."""
    g = torch.Generator(device=card).manual_seed(qs[2])
    q = torch.randn((qs[0], qs[2], qs[1], 64), generator=g,
                    device=card).to(dtype).transpose(1, 2)
    k, v = (torch.randn((ks[0], ks[2], ks[1], 64), generator=g,
                        device=card).to(dtype).transpose(1, 2)
            for _ in range(2))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=False)
    assert got.dtype == dtype and got.shape == want.shape == qs
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    assert _worst_row_rel(got, want) <= (
        F32_ROW_RTOL if dtype == torch.float32 else BF16_ROW_RTOL)


def test_whisper_goes_through_the_kernel(card):
    """A reduced Whisper on the card: a prefill launches once each
    encoder layer and twice each decoder layer, a decode step once a
    decoder layer (its cross-attention), and the decode path's logits
    equal the prefill's."""
    from repro_torch.configs import get_config
    from repro_torch.models import DenseLM, init_cache, init_params, reduced

    cfg = reduced(get_config("whisper_large_v3"), n_layers=3)
    gen = torch.Generator(card).manual_seed(0)
    model = DenseLM(cfg, init_params(cfg, gen, card))
    tokens = torch.randint(0, cfg.vocab, (2, 30), device=card)
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=card) * 0.02
    ops.reset_launch_counts()
    last = model.prefill(tokens, frames=frames)
    assert ops.launch_counts()["flash_attention"] == (
        cfg.encoder_layers + 2 * cfg.n_layers)
    cache = init_cache(cfg, 2, 30, card)
    cache["enc_out"].copy_(model.encode(frames))
    ops.reset_launch_counts()
    for i in range(30):
        logits, cache = model.serve_step(cache, tokens[:, i], i)
    assert ops.launch_counts()["flash_attention"] == 30 * cfg.n_layers
    torch.testing.assert_close(last, logits, rtol=0, atol=1e-4)


def test_mla_prefill_goes_through_the_kernel(card):
    """A reduced DeepSeek-V2 prefill on the card (MLA's q/k of 48 dims, v
    of 32, padded to the D 64 instance): one launch per layer, and with
    nothing dropped (capacity factor E / k) its logits equal the
    teacher-forced decode path's, naive and absorbed."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import DenseLM, init_cache, init_params, reduced

    cfg = reduced(get_config("deepseek_v2_236b"), n_layers=2)
    params = init_params(cfg, torch.Generator(card).manual_seed(0), card)
    model = DenseLM(cfg, params)
    tokens = torch.randint(0, cfg.vocab, (2, 40), device=card)
    ops.reset_launch_counts()
    last = model.prefill(tokens)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    for absorb in (False, True):
        m = DenseLM(dataclasses.replace(cfg, mla_absorb=absorb), params)
        cache = init_cache(cfg, 2, 40, card)
        for i in range(40):
            logits, cache = m.serve_step(cache, tokens[:, i], i)
        torch.testing.assert_close(last, logits, rtol=0, atol=1e-4)


def test_lm_prefill_goes_through_the_kernel(card):
    """A reduced ChatGLM3 prefill on the card: one launch per layer, and
    its logits equal the teacher-forced decode path's."""
    from repro_torch.configs import get_config
    from repro_torch.models import DenseLM, init_cache, init_params, reduced

    cfg = reduced(get_config("chatglm3_6b"), n_layers=3)
    model = DenseLM(cfg, init_params(cfg, torch.Generator(card).manual_seed(0),
                                     card))
    tokens = torch.randint(0, cfg.vocab, (2, 50), device=card)
    ops.reset_launch_counts()
    last = model.prefill(tokens)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    cache = init_cache(cfg, 2, 50, card)
    for i in range(50):
        logits, cache = model.serve_step(cache, tokens[:, i], i)
    torch.testing.assert_close(last, logits, rtol=0, atol=1e-4)


def test_serving_engine_on_the_card(card):
    """``ContinuousBatcher`` with ``device="cuda"`` and the weights on
    cuda:0 serves every request, as on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, reduced
    from repro_torch.serve import ContinuousBatcher, Request

    cfg = reduced(get_config("tinyllama_1_1b"), n_layers=2)
    params = init_params(cfg, torch.Generator(card).manual_seed(0), card)
    eng = ContinuousBatcher(cfg, params, n_slots=2, max_seq=32)
    for i in range(3):
        eng.submit(Request(uid=i, prompt=[1 + i, 2, 3], max_new=4))
    done = eng.run()
    assert [len(r.output) for r in done] == [4, 4, 4]


def test_multitenant_service_on_the_card(card, tmp_path):
    """``ForestPool`` / ``MultiTenantService`` with ``device="cuda"``
    answer a mixed-tenant batch as on the CPU, through cold loads into
    device-resident buckets and evictions, and a dispatch queues its
    copies and gathers without a host synchronisation (sync debug mode
    ``error``) before its result copy."""
    from repro_torch.hierarchy import (ForestPool, MultiTenantService,
                                       build_hierarchy, save_hierarchy)
    from repro_torch.launch.hserve import (_check_no_host_sync, _chunk_cols,
                                           _mixed_workload)

    for i in range(6):
        g = powerlaw_bipartite(*((40, 28, 120) if i % 3 else (12, 8, 24)),
                               seed=i)
        res = peel.wing_decomposition(g, P=4, engine="csr", device=card)
        save_hierarchy(str(tmp_path / f"t{i}.npz"),
                       build_hierarchy(g, res, device=card))
    tenants = [f"t{i}" for i in range(6)]
    answers = {}
    for dev in ("cpu", card):
        pool = ForestPool(slots=4, artifact_dir=str(tmp_path), device=dev)
        svc = MultiTenantService(pool, batch=64)
        got = []
        for k in range(3):
            window = tenants[k:k + 3]
            for t in window:
                pool.ensure(t)
            got.append(svc.query_batch(*_mixed_workload(
                pool, window, 300, seed=k)))
        answers[str(dev)] = np.concatenate(got)
        assert pool.stats()["evictions"] > 0
    np.testing.assert_array_equal(answers["cpu"], answers[str(card)])
    mixes = {}
    for key in pool.buckets:
        members = [t for t in pool.tenants() if pool.meta[t].bucket == key]
        mixes[key] = [_chunk_cols(svc, *_mixed_workload(pool, members, 32,
                                                        seed=s))
                      for s in (0, 1)]
    assert "sync_debug" in _check_no_host_sync(svc, pool, mixes)


def _load(name, *parts):
    """A module of the repository by path (none imports JAX)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), *parts)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_replay():
    """``tests/goldens/distributed_replay.py``."""
    return _load("distributed_replay", "tests", "goldens",
                 "distributed_replay.py")


def _smoke():
    """``chip_smoke.py`` (for ``mrope_image_positions``)."""
    return _load("chip_smoke", "chip_smoke.py")


def test_distributed_world_one_nccl_on_the_card(card, tmp_path):
    """A world-1 NCCL process group on the card: every cell of
    ``torch_distributed.json`` on the 1-D and the (1, 1) mesh equals the
    JAX package's θ, part, ranges, ⋈init and stats, with the module's
    collectives only (ρ_cd × 1 or 2 a CD round, none in FD)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_peel_mesh, make_peel_mesh_2d

    rp = _load_replay()
    golden = rp.load_golden()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        for mesh, axis in ((make_peel_mesh(device="cuda"), "peel"),
                           (make_peel_mesh_2d(device="cuda"),
                            ("grp", "loc"))):
            cells = rp.replay(golden, mesh, axis)
            for key, want in golden["results"].items():
                got = cells[key]
                for f in ("theta", "part", "ranges", "support_init",
                          "stats"):
                    assert got[f] == want[f], (key, f)
                assert got["counts"]["fd"] == 0, key
                assert got["calls"] == sum(got["counts"].values()), key
    finally:
        dist.destroy_process_group()


def test_edge_butterflies_csr_kernel_route_on_the_card(card):
    """``csr.edge_butterflies_csr(use_pallas=True)`` launches
    ``wedge_count`` and equals the plain route and ``edge_butterflies0``."""
    g = GRAPHS["pl800"]()
    w = csr.build_wedges(g)
    rng = np.random.default_rng(0)
    for alive in (None, torch.from_numpy(rng.random(g.m) > 0.3).to(card)):
        ops.reset_launch_counts()
        got = csr.edge_butterflies_csr(w, alive, use_pallas=True,
                                       device=card)
        assert ops.launch_counts()["wedge_count"] == 1
        want = csr.edge_butterflies_csr(w, alive, device=card)
        assert got.device.type == "cuda" and torch.equal(got, want)
        if alive is None:
            assert np.array_equal(got.cpu().numpy(),
                                  csr.edge_butterflies0(w))


# relative L2 of a gradient through the kernel against torch autograd
# through the plain version: the f32 forward's gate is 1e-4 a row
# (chip_smoke.py, ATTN_ROW_RTOL), and the backward is the same torch ops
# on both sides, so the gradients inherit that; in bf16 the forward's
# row gate is 1e-2, and both routes' gradients are rounded to bf16
GRAD_RTOL = 1e-4
GRAD_RTOL_BF16 = 1e-2


@pytest.mark.parametrize("shape,kv,causal,offset,dtype", [
    ((2, 8, 256, 64), 2, True, 0, torch.float32),  # 3xTF32 route, GQA
    ((2, 4, 200, 32), 2, True, 0, torch.float32),  # CUDA cores, ragged
    ((1, 4, 64, 64), 4, True, 192, torch.float32),  # the cache's end
    ((1, 4, 96, 32), 1, False, 0, torch.float32),
    # Whisper's cross-attention (Sq 448 and 1 against Sk 1 500, 20/20
    # heads of D 64, non-causal): Sk = Sq + offset
    ((2, 20, 448, 64), 20, False, 1052, torch.float32),
    ((2, 20, 448, 64), 20, False, 1052, torch.bfloat16),
    ((2, 20, 1, 64), 20, False, 1499, torch.float32),
    ((2, 20, 1, 64), 20, False, 1499, torch.bfloat16),
])
def test_flash_attention_grads_on_the_card(card, shape, kv, causal, offset,
                                           dtype):
    """dq, dk, dv through ``FlashAttention`` (the kernel forward) against
    torch autograd through the plain version, both on the card, in
    ``dtype``; the kernel launches once."""
    gen = torch.Generator(card).manual_seed(sum(shape))
    B, H, sq, D = shape
    sk = sq + offset if offset else sq
    q = torch.randn(shape, generator=gen, device=card).to(dtype)
    k, v = (torch.randn((B, kv, sk, D), generator=gen, device=card).to(dtype)
            for _ in range(2))
    w = torch.randn(shape, generator=gen, device=card).to(dtype)
    rtol = GRAD_RTOL if dtype == torch.float32 else GRAD_RTOL_BF16
    grads = []
    for fn in (ops.flash_attention, lambda *a, **kw: ref.flash_attention_ref(
            *a, **kw)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ops.reset_launch_counts()
        (fn(*leaves, causal=causal, offset=offset) * w).sum().backward()
        grads.append([t.grad for t in leaves])
        if not grads[1:]:
            assert ops.launch_counts()["flash_attention"] == 1
    for a, b in zip(*grads):
        assert a.dtype == b.dtype == dtype
        assert ((a.float() - b.float()).norm()
                / b.float().norm()).item() <= rtol


@pytest.mark.parametrize("d,dv,causal", [(192, 128, True), (112, 112, True),
                                         (192, 128, False)])
def test_flash_attention_grads_at_padded_head_dims(card, d, dv, causal):
    """``FlashAttention`` at head dims padded to an instance (MLA's
    192 / 128 to 256, Zamba2's 112 to 128): dq, dk and dv through the
    kernel forward (one launch) and the backward at Dv against torch
    autograd through the plain version, within ``GRAD_RTOL``."""
    gen = torch.Generator(card).manual_seed(d + dv)
    q, k = (torch.randn((1, 8, 192, d), generator=gen, device=card)
            for _ in range(2))
    v = torch.randn((1, 8, 192, dv), generator=gen, device=card)
    w = torch.randn((1, 8, 192, dv), generator=gen, device=card)
    grads = []
    for fn in (ops.flash_attention, ref.flash_attention_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ops.reset_launch_counts()
        (fn(*leaves, causal=causal) * w).sum().backward()
        grads.append([t.grad for t in leaves])
        if len(grads) == 1:
            assert ops.launch_counts()["flash_attention"] == 1
    for a, b in zip(*grads):
        assert a.shape == b.shape
        assert ((a - b).norm() / b.norm()).item() <= GRAD_RTOL


@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "dbrx_132b",
                                  "xlstm_1_3b", "zamba2_7b",
                                  "whisper_large_v3", "qwen2_vl_72b"])
def test_reduced_grads_on_the_card_equal_the_cpu(card, arch):
    """``train_loss`` and every gradient leaf of a reduced MoE, SSM,
    hybrid, audio or VLM model on the card (attention through the kernel:
    MLA padded to D 64, Zamba2's shared block at D 32, Whisper's encoder
    and cross-attention non-causal, Qwen2-VL under M-RoPE positions with
    an image block) against the same on the CPU (the plain version),
    ``convert.numpy_params`` weights: the loss to 1e-5 relative, each
    leaf within ``GRAD_RTOL`` (the SSM and hybrid families within
    ``tests/test_torch_ssm.py``'s 2e-4: their chunked recurrence
    amplifies f32 rounding, and the two devices sum in other orders);
    ``flash_attention`` launches twice an attention (forward and
    recompute)."""
    from repro_torch.configs import get_config
    from repro_torch.models import reduced, train_loss
    from repro_torch.models.convert import numpy_params, params_from_numpy
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = reduced(get_config(arch))
    tree = numpy_params(cfg, seed=2)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))
             for k in ("tokens", "labels")}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy((rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32))
    if cfg.rope_type == "mrope":
        batch["positions"] = torch.from_numpy(
            _smoke().mrope_image_positions(2, 32, 4, (4, 4)))
    out = {}
    for dev in ("cpu", card):
        leaves = tree_map(lambda t: t.requires_grad_(),
                          params_from_numpy(tree, cfg, device=dev))
        ops.reset_launch_counts()
        loss = train_loss(leaves, {k: v.to(dev) for k, v in batch.items()},
                          cfg)
        out[str(dev)] = (loss.item(), torch.autograd.grad(
            loss, tree_leaves(leaves)))
    attn = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
            "audio": cfg.encoder_layers + 2 * cfg.n_layers}.get(
        cfg.family, cfg.n_layers)
    assert ops.launch_counts()["flash_attention"] == 2 * attn
    (l0, g0), (l1, g1) = out["cpu"], out[str(card)]
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    rtol = 2e-4 if cfg.is_recurrent else GRAD_RTOL
    for a, b in zip(g1, g0):
        assert ((a.cpu() - b).norm() / b.norm()).item() <= rtol


def test_reduced_train_step_on_the_card(card):
    """One train step of a reduced TinyLlama on the card against the
    same step on the CPU (``convert.numpy_params`` weights): loss and
    gradient norm to 1e-5 relative, the weights to 1e-5 relative but for
    at most 0.1 % of a tensor (Adam normalises each gradient component:
    one whose rounding differs near 0 moves its weight by up to a step,
    bounded by the learning rate); ``flash_attention`` launches twice a
    layer (forward and the full-remat recompute)."""
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    from repro_torch.models.convert import numpy_params, params_from_numpy
    from repro_torch.train import (AdamWConfig, TrainConfig, adamw_init,
                                   make_train_step)
    from repro_torch.train.tree import tree_leaves

    cfg = reduced(get_config("tinyllama_1_1b"), n_layers=2)
    tree = numpy_params(cfg, seed=3)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64)))
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, TrainConfig(opt=AdamWConfig(
        lr=1e-2, warmup_steps=1)))
    out = {}
    for dev in ("cpu", card):
        params = params_from_numpy(tree, cfg, device=dev)
        ops.reset_launch_counts()
        out[str(dev)] = step(params, adamw_init(params),
                             {k: v.to(dev) for k, v in batch.items()})
        if dev is card:
            assert ops.launch_counts()["flash_attention"] == 2 * cfg.n_layers
    (p0, _, m0), (p1, _, m1) = out["cpu"], out[str(card)]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(m1[k].item(), m0[k].item(), rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p0)):
        a = a.cpu().numpy()
        b = b.numpy()
        off = ~np.isclose(a, b, rtol=1e-5, atol=1e-6)
        assert off.mean() <= 1e-3
        assert np.abs(a - b).max() <= 1e-2


def test_remesh_world_one_nccl_on_the_card(card, tmp_path):
    """A world-1 NCCL group: ``remesh`` of reduced TinyLlama's parameters
    and AdamW state onto ``make_local_mesh`` gives ``DTensor``s on the
    card, each equal to its input, re-placed again from them unchanged;
    a train step from the re-placed state (its local shards) equals the
    step from the plain tensors."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import logical_axes, reduced
    from repro_torch.models.convert import numpy_params, params_from_numpy
    from repro_torch.train import (AdamWConfig, TrainConfig, adamw_init,
                                   make_train_step, remesh)
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = reduced(get_config("tinyllama_1_1b"), n_layers=2)
    params = params_from_numpy(numpy_params(cfg, seed=3), cfg, device=card)
    opt = adamw_init(params)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(card)
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, TrainConfig(opt=AdamWConfig(
        lr=1e-2, warmup_steps=1)))
    flat = lambda p, o: tree_leaves(p) + tree_leaves(o)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(device="cuda")
        assert tuple(mesh.shape) == (1, 1)
        p1, o1 = remesh(params, opt, logical_axes(cfg), mesh)
        p2, o2 = remesh(p1, o1, logical_axes(cfg), mesh)
        for a, b in zip(flat(params, opt), flat(p2, o2), strict=True):
            assert isinstance(b, DTensor) and b.to_local().is_cuda
            assert torch.equal(b.to_local(), a)
        local = lambda t: tree_map(lambda d: d.to_local(), t)
        got = step(local(p2), type(o2)(*map(local, o2)), batch)
        want = step(params, opt, batch)
        for a, b in zip(flat(*got[:2]), flat(*want[:2]), strict=True):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "chatglm3_6b",
                                  "dbrx_132b", "zamba2_7b"])
def test_sharded_step_world_one_nccl_on_the_card(card, tmp_path, arch):
    """A world-1 NCCL group on the (1, 1) mesh: the train step on the
    placed ``DTensor`` state itself (``constrain`` and ``local_map``
    live, ``flash_attention`` launched through ``local_map``) equals the
    plain step bit for bit, and so do a prefill and two decode steps
    through the mesh path."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import (init_cache, logical_axes, prefill,
                                    reduced, serve_step)
    from repro_torch.models.convert import numpy_params, params_from_numpy
    from repro_torch.sharding import (batch_shardings, cache_shardings,
                                      distribute, use_mesh)
    from repro_torch.train import (AdamWConfig, TrainConfig, adamw_init,
                                   make_train_step, remesh)
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = reduced(get_config(arch))
    params = params_from_numpy(numpy_params(cfg, seed=3), cfg, device=card)
    opt = adamw_init(params)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))).to(card)
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, TrainConfig(opt=AdamWConfig(
        lr=1e-2, warmup_steps=1)))
    flat = lambda p, o: tree_leaves(p) + tree_leaves(o)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(device="cuda")
        place = lambda t: tree_map(distribute, t, batch_shardings(t, mesh))
        p1, o1 = remesh(params, opt, logical_axes(cfg), mesh)
        ops.reset_launch_counts()
        got = step(p1, o1, place(batch))
        assert ops.launch_counts()["flash_attention"] > 0
        want = step(params, opt, batch)
        for a, b in zip(flat(*got[:2]), flat(*want[:2]), strict=True):
            assert isinstance(a, DTensor) and torch.equal(a.to_local(), b)
        with torch.no_grad():
            tok = batch["tokens"]
            with use_mesh(mesh):
                lg = prefill(p1, place(dict(t=tok))["t"], cfg)
            assert torch.equal(lg.to_local(), prefill(params, tok, cfg))
            cache = init_cache(cfg, 2, 4, card, torch.float32)
            cache_m = tree_map(distribute, init_cache(cfg, 2, 4, card,
                                                      torch.float32),
                               cache_shardings(cache, mesh, cfg))
            for t in range(2):
                x = tok[:, t].contiguous()
                a, cache = serve_step(params, cache, x, t, cfg)
                with use_mesh(mesh):
                    b, cache_m = serve_step(p1, cache_m,
                                            place(dict(t=x))["t"], t, cfg)
                assert torch.equal(b.to_local(), a)
    finally:
        dist.destroy_process_group()
