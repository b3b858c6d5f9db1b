"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``); the ``card``
fixture skips them where ``torch.cuda.is_available()`` is False.  The
file imports no JAX (the card's machine has none): inputs come from the
port's own packers on small graphs.  Run on a machine with a card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import counting, csr, peel, peelspec
from repro_torch.core.beindex import build_beindex
from repro_torch.core.distributed import (pack_fd_partitions_csr,
                                          pack_fd_partitions_tip_csr)
from repro_torch.core.graph import powerlaw_bipartite, random_bipartite
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bloom_update import bloom_update
from repro_torch.kernels.butterfly_count import (matmul, vertex_count,
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


@pytest.mark.parametrize("n_u,n_v,m", [(40, 30, 200), (130, 70, 700),
                                       (257, 129, 1500), (300, 500, 6000)])
def test_vertex_count_kernels_equal_plain(card, n_u, n_v, m):
    g = random_bipartite(n_u, n_v, m, seed=n_u + m)
    A = torch.from_numpy(g.adjacency()).to(card)
    # unpadded: the kernel bounds-checks every load
    got, n = _launched("vertex_count", lambda: vertex_count(A))
    assert n == 1 and torch.equal(got, ref.vertex_butterflies_ref(A))
    assert torch.equal(ops.vertex_butterflies(A),
                       counting.vertex_butterflies(A))
    for r0, r1 in ((0, n_u), (3, min(n_u, 131))):
        strip = A[r0:r1].contiguous()
        got, n = _launched("vertex_count_tile",
                           lambda: vertex_count_tile(strip, A))
        assert n == 1
        assert torch.equal(got, ref.vertex_count_tile_ref(strip, A))
    tiled, n = _launched("vertex_count_tile",
                         lambda: ops.vertex_butterflies_tiled(A, 128))
    assert n == -(-n_u // 128)
    assert torch.equal(tiled, torch.round(
        counting.vertex_butterflies(A).double()).to(torch.int64))


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


def test_new_wrappers_reject_what_the_kernels_do_not_take(card):
    x = torch.zeros((4, 128), device=card)
    with pytest.raises(TypeError):
        vertex_count(x.double())
    with pytest.raises(ValueError, match="shape"):
        vertex_count_tile(x, torch.zeros((4, 64), device=card))
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
