"""The plain reference against brute force on tiny graphs: butterflies
enumerated one by one, a sequential bottom-up peel, and the hierarchy's
components found level by level."""
import itertools

import numpy as np
import pytest

from portbench import graphgen
from portbench.reference import hierarchy, reference_theta, tip, wing
from portbench.reference.rounding import round_significand

GRAPHS = [(7, 6, 30, 0.3, 0), (10, 8, 45, 0.6, 1), (12, 9, 60, 0.9, 2),
          (9, 12, 55, 0.6, 3), (14, 10, 70, 1.2, 4)]


def _graph(n_u, n_v, m, alpha, seed):
    e = graphgen.powerlaw_edges(n_u, n_v, m, alpha, seed)
    return n_u, n_v, graphgen.relabel(e, n_u, n_v, seed + 100)


def _butterflies(edges):
    """Every butterfly as (u1, u2, v1, v2), u1 < u2, v1 < v2."""
    es = set(map(tuple, edges.tolist()))
    us = sorted({u for u, _ in es})
    vs = sorted({v for _, v in es})
    return [(a, b, x, y) for a, b in itertools.combinations(us, 2)
            for x, y in itertools.combinations(vs, 2)
            if {(a, x), (a, y), (b, x), (b, y)} <= es]


def _sequential_peel(items, members_of):
    """theta of each item: peel the item of least support one at a time,
    support = the butterflies left that hold it."""
    alive_bf = set(range(len(members_of)))
    holds = {i: {j for j in alive_bf if i in members_of[j]} for i in items}
    theta, k, left = {}, 0, set(items)
    while left:
        i = min(left, key=lambda x: (len(holds[x] & alive_bf), x))
        k = max(k, len(holds[i] & alive_bf))
        theta[i] = k
        left.remove(i)
        alive_bf -= holds[i]
    return theta


@pytest.mark.parametrize("g", GRAPHS)
def test_tip_numbers_equal_a_sequential_peel(g):
    n_u, n_v, e = _graph(*g)
    bfs = _butterflies(e)
    want = _sequential_peel(range(n_u), [{a, b} for a, b, _, _ in bfs])
    got = tip.tip_numbers(n_u, n_v, e)
    assert got.tolist() == [want[u] for u in range(n_u)]
    # the other side, through the configuration's "side"
    got_v = reference_theta({"decomposition": "tip", "side": "v"},
                            n_u, n_v, e)
    want_v = _sequential_peel(range(n_v), [{x, y} for _, _, x, y in bfs])
    assert got_v.tolist() == [want_v[v] for v in range(n_v)]


@pytest.mark.parametrize("g", GRAPHS)
def test_wing_numbers_equal_a_sequential_peel(g):
    n_u, n_v, e = _graph(*g)
    bfs = _butterflies(e)
    rows = [tuple(r) for r in e.tolist()]
    want = _sequential_peel(
        rows, [{(a, x), (a, y), (b, x), (b, y)} for a, b, x, y in bfs])
    assert wing.wing_numbers(n_u, n_v, e).tolist() == [want[r] for r in rows]
    # reference_theta reports them in (u, v) lexicographic order
    order = np.lexsort((e[:, 1], e[:, 0]))
    got = reference_theta({"decomposition": "wing"}, n_u, n_v, e)
    assert got.tolist() == [want[rows[i]] for i in order]


def _components(n, adj, alive):
    comp, out = [-1] * n, []
    for s in range(n):
        if not alive[s] or comp[s] >= 0:
            continue
        stack, members = [s], []
        comp[s] = len(out)
        while stack:
            x = stack.pop()
            members.append(x)
            for y in adj[x]:
                if alive[y] and comp[y] < 0:
                    comp[y] = len(out)
                    stack.append(y)
        out.append(frozenset(members))
    return out


@pytest.mark.parametrize("g", GRAPHS)
def test_tip_hierarchy_and_answers_equal_brute_force(g):
    n_u, n_v, e = _graph(*g)
    theta = tip.tip_numbers(n_u, n_v, e)
    nbr = [set() for _ in range(n_u)]
    for u, v in e.tolist():
        nbr[u].add(v)
    adj = [[y for y in range(n_u) if y != x and len(nbr[x] & nbr[y]) >= 2]
           for x in range(n_u)]
    nodes = []                       # (level, least id, members)
    for k in sorted(set(theta.tolist()) - {0}):
        for c in _components(n_u, adj, theta >= k):
            if any(theta[x] == k for x in c):
                nodes.append((k, min(c), c))
    nodes.sort(key=lambda t: (t[0], t[1]))
    level = [0] + [k for k, _, _ in nodes]
    sets = [frozenset(range(n_u))] + [c for _, _, c in nodes]
    parent = [-1]
    for i, (k, _, c) in enumerate(nodes, start=1):
        above = [j for j in range(1, i) if level[j] < k and c <= sets[j]]
        parent.append(max(above, key=lambda j: level[j]) if above else 0)
    node_of = [0] * n_u
    for i in range(1, len(sets)):
        for x in sets[i]:
            if theta[x] == level[i]:
                node_of[x] = i
    f = hierarchy.tip_forest(n_u, n_v, e, theta)
    assert f["node_level"].tolist() == level
    assert f["parent"].tolist() == parent
    assert f["entity_node"].tolist() == node_of
    assert f["size"].tolist() == [len(s) for s in sets]

    def chain(x):
        out = [x]
        while parent[out[-1]] >= 0:
            out.append(parent[out[-1]])
        return out

    rng = np.random.default_rng(g[-1])
    ops = rng.integers(0, 5, 200)
    a = rng.integers(0, n_u, 200)
    b = rng.integers(0, n_u, 200)
    a = np.where(ops == 4, rng.integers(0, len(sets), 200), a)
    want = []
    for op, x, y in zip(ops.tolist(), a.tolist(), b.tolist()):
        if op == 0:
            want.append(int(theta[x]))
        elif op == 1:
            want.append(node_of[x])
        elif op in (2, 3):
            cy = set(chain(node_of[y]))
            lca = next(z for z in chain(node_of[x]) if z in cy)
            want.append(lca if op == 2 else level[lca])
        else:
            want.append(len(sets[x]))
    assert hierarchy.answers(f, ops, a, b).tolist() == want


def test_round_significand():
    x = np.array([0, 1, 255, 256, 257, 258, 259, 1 << 24, (1 << 24) + 1])
    assert round_significand(x, 8).tolist() == [
        0, 1, 255, 256, 256, 258, 260, 1 << 24, 1 << 24]
    assert round_significand(x, 24).tolist() == x.tolist()[:-1] + [1 << 24]
    assert round_significand(x, 0).tolist() == x.tolist()
