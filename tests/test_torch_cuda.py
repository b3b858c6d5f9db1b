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

from repro_torch.core import csr, peel, peelspec
from repro_torch.core.distributed import (pack_fd_partitions_csr,
                                          pack_fd_partitions_tip_csr)
from repro_torch.core.graph import powerlaw_bipartite, random_bipartite
from repro_torch.kernels import ops, ref
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
        kw = dict(P=6, fd_driver=parts[-1], fused=True, device=card)
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
        res = fn(g, P=8, device="cpu")
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
