"""The port's hierarchy (build, queries, artifacts, service) against the
JAX package's, on the small graphs of ``tests/test_hierarchy.py``.

* ``build_hierarchy`` of both packages gives equal forests — every
  array, its dtype and the meta — for wing, tip side u and tip side v,
  at ``level_block`` 1 and 32 (labels on the CPU here; on the card in
  ``tests/test_torch_cuda.py``);
* artifacts written by either package load in the other, format v1 and
  v2, with equal arrays and meta;
* point queries, LCA, subgraph masks, density profiles, the densest
  leaves and a seeded ``HierarchyService`` batch give the JAX answers;
* the service rejects what the JAX service rejects, with the same text.
"""
import io

import numpy as np
import pytest
import torch

from repro.core.graph import BipartiteGraph as JGraph
from repro.core.graph import powerlaw_bipartite as jpowerlaw
from repro.core.peel import tip_decomposition as jtip
from repro.core.peel import wing_decomposition as jwing
from repro import hierarchy as jh
from repro_torch import hierarchy as th
from repro_torch.core.graph import BipartiteGraph as TGraph
from repro_torch.core.graph import powerlaw_bipartite as tpowerlaw
from repro_torch.core.peel import tip_decomposition as ttip
from repro_torch.core.peel import wing_decomposition as twing
from repro_torch.hierarchy.serialize import _ARRAY_FIELDS

torch.set_num_threads(1)

TWO_BLOBS = [(0, 0), (0, 1), (1, 0), (1, 1), (2, 2), (2, 3), (3, 2), (3, 3),
             (1, 2)]
NESTED = ([(u, v) for u in range(3) for v in range(3)]
          + [(u, v) for u in (3, 4) for v in (3, 4)] + [(2, 3)])
GRAPHS = {
    "two_blobs": (lambda G: G.from_edges(4, 4, TWO_BLOBS), None),
    "nested": (lambda G: G.from_edges(5, 5, NESTED), None),
    "pl60": (None, (60, 40, 260, 7)),
    "pl50": (None, (50, 35, 200, 11)),
}
CASES = [("wing", "u"), ("tip", "u"), ("tip", "v")]


def _graphs(name):
    edges, pl = GRAPHS[name]
    if pl is not None:
        return jpowerlaw(*pl[:3], seed=pl[3]), tpowerlaw(*pl[:3], seed=pl[3])
    return edges(JGraph), edges(TGraph)


def _peel(name, kind, side, P=4):
    jg, tg = _graphs(name)
    if kind == "wing":
        return (jg, jwing(jg, P=P, engine="csr"), tg,
                twing(tg, P=P, engine="csr", device="cpu"))
    return (jg, jtip(jg, side=side, P=P, engine="csr"), tg,
            ttip(tg, side=side, P=P, engine="csr", device="cpu"))


def _forests(name, kind, side, level_block=32):
    jg, jr, tg, tr = _peel(name, kind, side)
    return (jh.build_hierarchy(jg, jr, kind=kind, side=side,
                               level_block=level_block),
            th.build_hierarchy(tg, tr, kind=kind, side=side,
                               level_block=level_block, device="cpu"))


def _assert_meta_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


def _assert_forest_equal(t, j):
    assert (t.kind, t.n_entities, t.n_nodes) == (j.kind, j.n_entities,
                                                  j.n_nodes)
    for f in _ARRAY_FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    _assert_meta_equal(t.meta, j.meta)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("level_block", [1, 32])
@pytest.mark.parametrize("kind,side", CASES)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_build_hierarchy_equals_reference(name, kind, side, level_block):
    j, t = _forests(name, kind, side, level_block)
    _assert_forest_equal(t, j)


def test_build_from_raw_theta_and_shape_check():
    jg, jr, tg, tr = _peel("pl60", "wing", "u")
    _assert_forest_equal(
        th.build_hierarchy(tg, tr.theta, device="cpu", meta=dict(x=1)),
        jh.build_hierarchy(jg, jr.theta, meta=dict(x=1)))
    with pytest.raises(ValueError, match="expected"):
        th.build_hierarchy(tg, tr.theta[:-1], device="cpu")


def test_empty_and_butterfly_free_graphs():
    for edges in (np.zeros((0, 2), np.int32), [[0, 0], [1, 1]]):
        jg = JGraph.from_edges(3, 3, edges)
        tg = TGraph.from_edges(3, 3, edges)
        j = jh.build_hierarchy(jg, jwing(jg, P=2, engine="csr"))
        t = th.build_hierarchy(tg, twing(tg, P=2, engine="csr",
                                         device="cpu"), device="cpu")
        _assert_forest_equal(t, j)
        svc = th.HierarchyService(t, batch=8, device="cpu")
        svc.submit(th.HQuery(uid=0, op="subtree_size", a=0))
        assert svc.run()[0].result == \
            jh.HierarchyService(j, batch=8).query_batch([4], [0])[0]


# ------------------------------------------------------------- artifacts
@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("kind,side", CASES)
def test_artifacts_cross_load(kind, side, version):
    j, t = _forests("pl60", kind, side)
    for writer, reader, src in ((jh.save_hierarchy, th.load_hierarchy, j),
                                (th.save_hierarchy, jh.load_hierarchy, t)):
        buf = io.BytesIO()
        writer(buf, src, version=version)
        buf.seek(0)
        got = reader(buf)
        pack = [got.meta.pop(k, None) for k in ("pack_depth", "pack_up")]
        _assert_forest_equal(got, src)
        if version == 2:
            for x, y in zip(pack, jh.depth_and_up(src.parent)):
                np.testing.assert_array_equal(x, y)
        else:
            assert pack == [None, None]
    # both packages write the same npz members with the same contents
    bj, bt = io.BytesIO(), io.BytesIO()
    jh.save_hierarchy(bj, j, version=version)
    th.save_hierarchy(bt, t, version=version)
    bj.seek(0)
    bt.seek(0)
    with np.load(bj) as zj, np.load(bt) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for key in zj.files:
            np.testing.assert_array_equal(zt[key], zj[key], err_msg=key)


def test_artifact_version_guard_and_exact_path(tmp_path):
    j, t = _forests("two_blobs", "wing", "u")
    with pytest.raises(ValueError, match="cannot write"):
        th.save_hierarchy(io.BytesIO(), t, version=99)
    p = tmp_path / "artifact_no_suffix"
    th.save_hierarchy(str(p), t, version=1)
    assert p.exists() and not (tmp_path / "artifact_no_suffix.npz").exists()
    _assert_forest_equal(jh.load_hierarchy(str(p)), t)


# --------------------------------------------------------------- queries
@pytest.mark.parametrize("kind,side", CASES)
def test_queries_equal_reference(kind, side):
    j, t = _forests("pl60", kind, side)
    fj, ft = jh.pack_forest(j), th.pack_forest(t, device="cpu")
    assert (ft.n_nodes, ft.n_entities, ft.J) == (fj.n_nodes, fj.n_entities,
                                                fj.J)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, j.n_entities, 64)
    ids2 = rng.integers(0, j.n_entities, 64)
    nodes = rng.integers(0, j.n_nodes, 16)
    nodes2 = rng.integers(0, j.n_nodes, 16)
    for fn, args in ((jh.max_k_containing, (ids,)), (jh.node_of, (ids,)),
                     (jh.subgraph_at, (nodes,)),
                     (jh.lca_entities, (ids, ids2)),
                     (jh.lca_nodes, (nodes, nodes2))):
        want = np.asarray(fn(fj, *args))
        got = _np(getattr(th, fn.__name__)(ft, *args))
        assert got.dtype == want.dtype, fn.__name__
        np.testing.assert_array_equal(got, want, err_msg=fn.__name__)
    for k in [0, *t.levels[:4].tolist()]:
        a, b = th.density_profile(t, k), jh.density_profile(j, k)
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    a, b = th.top_densest_leaves(t, 5), jh.top_densest_leaves(j, 5)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_depth_and_up_and_extend_up_equal_reference():
    j, _ = _forests("pl50", "tip", "v")
    for J in (0, 3, 7):
        for a, b in zip(th.depth_and_up(j.parent, J),
                        jh.depth_and_up(j.parent, J)):
            np.testing.assert_array_equal(a, b)
    from repro.hierarchy.query import extend_up as jextend

    _, up = jh.depth_and_up(j.parent)
    np.testing.assert_array_equal(th.extend_up(up, 6), jextend(up, 6))


# --------------------------------------------------------------- service
@pytest.mark.parametrize("kind,side", CASES)
def test_service_batch_equals_reference(kind, side):
    j, t = _forests("pl60", kind, side)
    sj, st = jh.HierarchyService(j, batch=64), th.HierarchyService(
        t, batch=64, device="cpu")
    rng = np.random.default_rng(1)
    n = 1000
    ops = rng.integers(0, 5, n)
    a = np.where(ops == 4, rng.integers(0, j.n_nodes, n),
                 rng.integers(0, j.n_entities, n))
    b = rng.integers(0, j.n_entities, n)
    want = np.asarray(sj.query_batch(ops, a, b))
    got = st.query_batch(ops, a, b)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # the queue path, not a multiple of the batch size
    names = list(th.OPS)
    for svc in (sj, st):
        for i in range(200):
            svc.submit(jh.HQuery(uid=i, op=names[int(ops[i])], a=int(a[i]),
                                 b=int(b[i])) if svc is sj else
                       th.HQuery(uid=i, op=names[int(ops[i])], a=int(a[i]),
                                 b=int(b[i])))
    rj, rt = sj.run(), st.run()
    assert [q.result for q in rt] == [q.result for q in rj]
    assert (st.served, st.pending()) == (sj.served, sj.pending())
    nodes = np.arange(j.n_nodes)
    np.testing.assert_array_equal(st.subgraph_masks(nodes),
                                  np.asarray(sj.subgraph_masks(nodes)))


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_service_rejects_like_reference():
    j, t = _forests("two_blobs", "wing", "u")
    sj = jh.HierarchyService(j)
    st = th.HierarchyService(t, device="cpu")
    m = j.n_entities
    for op, a, b in (("nope", 0, 0), ("max_k", m + 5, 0),
                     ("lca_node", 0, -1), ("subtree_size", j.n_nodes, 0)):
        assert _error(lambda: st.submit(th.HQuery(0, op, a, b))) == \
            _error(lambda: sj.submit(jh.HQuery(0, op, a, b)))
    assert _error(lambda: st.query_batch(np.asarray([0]), np.asarray([m]))) \
        == _error(lambda: sj.query_batch(np.asarray([0]), np.asarray([m])))
    bad = np.asarray([j.n_nodes])
    assert _error(lambda: st.subgraph_masks(bad)) == \
        _error(lambda: sj.subgraph_masks(bad))
    # the valid node-arg query still serves
    st.submit(th.HQuery(uid=1, op="subtree_size", a=j.n_nodes - 1))
    assert st.run()[0].result == 4
