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
from repro_torch.kernels.wedge_count import wedge_count

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
