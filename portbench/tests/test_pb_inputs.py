"""The frozen generator and the run's relabelling, held to fixed digests:
a change that moves the yardstick's inputs fails here."""
import json
import os

import numpy as np
import pytest

from portbench import graphgen

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EDGES = {
    (400, 300, 3000, 0.6, 0):
        "d74ad1300589f8cc92c2c2db04af606bc7da31f8ef17cd0cb7ff54569517d7c2",
    (943, 1682, 100000, 0.6, 0):
        "1df183fcb36977a2d0f32592bf126ed94094479106a6f048c4312a8c483c73fe",
}
# each configuration's edges for the run seed 2**31 + 11
RUNS = {
    "bcl-56k": (56519, 120867, 440237,
               "26ff8f54fa6f35f2217a42a3f6affb963b9c8c9c5365d67df49549c52fecfad3"),
    "bcl-943": (560, 1682, 60791,
                       "35c19c8d5c670b8e7f214ba31b1e373426766d9d3f11caaed5eca0af013ea59c"),
}


@pytest.mark.parametrize("args", sorted(EDGES))
def test_powerlaw_edges_digest(args):
    e = graphgen.powerlaw_edges(*args)
    assert e.shape == (args[2], 2)
    assert graphgen.edges_digest(e) == EDGES[args]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_configuration_graph_digest(name):
    with open(os.path.join(PB, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    n_u, n_v, e = graphgen.make_graph(cfg, 2**31 + 11)
    assert (n_u, n_v, e.shape[0]) == RUNS[name][:3]
    assert graphgen.edges_digest(e) == RUNS[name][3]


def test_relabel_keeps_the_graph():
    e = graphgen.powerlaw_edges(50, 40, 300, 0.6, 3)
    r = graphgen.relabel(e, 50, 40, 2**40 + 5)
    assert not np.array_equal(r, e)
    # the same degree sequences and no repeated edge: one graph, renamed
    assert sorted(np.bincount(r[:, 0], minlength=50)) == sorted(
        np.bincount(e[:, 0], minlength=50))
    assert sorted(np.bincount(r[:, 1], minlength=40)) == sorted(
        np.bincount(e[:, 1], minlength=40))
    assert np.unique(r, axis=0).shape == e.shape
    assert np.array_equal(graphgen.relabel(e, 50, 40, 2**40 + 5), r)


def test_user_subset():
    e = graphgen.powerlaw_edges(60, 40, 500, 0.6, 1)
    s, n = graphgen.user_subset(e, 60, 45, 0)
    assert n == 45 and s[:, 0].max() < 45
    kept = np.sort(np.random.default_rng(0).choice(60, 45, replace=False))
    assert s.shape[0] == int(np.isin(e[:, 0], kept).sum())
