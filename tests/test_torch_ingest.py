"""The port's real-data front door against the JAX package's.

* ``repro_torch.data.ingest_edges`` writes the same ingest directory as
  ``repro.data.ingest_edges`` — every memmap and ``meta.json``, byte for
  byte — on seeded edge lists with deletions, duplicates, 0- and 1-based
  ids and both comment styles, at several chunk sizes; a cache written
  by either package loads in the other.
* Chunk- and order-invariance against a dict oracle (hypothesis; the
  strategies are bound by keyword).
* ``tiled_butterfly_init`` — the host path and the kernel route on the
  CPU (``use_pallas=True``, the plain version of ``wedge_count_tile``) —
  equals the JAX package's and the untiled counts, at tile budgets that
  force several tiles and hub tiles.
* ``datasets/southern_women.tsv`` through the port gives the θ digests
  and the total of ``tests/goldens/real_graphs.json``.
"""
import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import csr as jcsr
from repro.core.graph import paper_proxy_dataset as jproxy
from repro.core.graph import powerlaw_bipartite as jpowerlaw
from repro.data import ingest as jingest
from repro_torch.core import csr as tcsr
from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.graph import paper_proxy_dataset as tproxy
from repro_torch.core.graph import powerlaw_bipartite as tpowerlaw
from repro_torch.data import ingest as tingest

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DATASET = os.path.join(HERE, "..", "datasets", "southern_women.tsv")
FILES = ("edges.bin", "off_u.bin", "off_v.bin", "nbr_v.bin", "eid_v.bin",
         "meta.json")
ARRAYS = ("edges", "off_u", "off_v", "nbr_v", "eid_v")


def _write(path, ops, order=None, comment="%", base=0):
    lines = [f"{u + base}\t{v + base}" if s > 0
             else f"{u + base}\t{v + base}\t-1" for u, v, s in ops]
    if order is not None:
        lines = [lines[i] for i in order]
    with open(path, "w") as f:
        f.write(f"{comment} bip unweighted\n")
        for i, line in enumerate(lines):
            if i % 7 == 3:
                f.write(f"{comment} a comment line\n\n")
            f.write(line + "\n")


def _seeded_ops(seed, n=300, n_u=40, n_v=25):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_u, n)
    v = rng.integers(0, n_v, n)
    sign = np.where(rng.random(n) < 0.2, -1, 1)   # deletions
    ops = [(int(a) * 3 + 5, int(b) * 11 + 2, int(s))
           for a, b, s in zip(u, v, sign)]
    return ops + ops[:40]                          # duplicates


def _assert_same_graph(a, b):
    assert (a.n_u, a.n_v, a.m) == (b.n_u, b.n_v, b.m)
    for key in ARRAYS:
        x, y = np.asarray(getattr(a, key)), np.asarray(getattr(b, key))
        assert x.dtype == y.dtype, key
        np.testing.assert_array_equal(x, y, err_msg=key)
    assert a.meta == b.meta


def _assert_same_files(d1, d2):
    for name in FILES:
        with open(os.path.join(d1, name), "rb") as f1, \
                open(os.path.join(d2, name), "rb") as f2:
            assert f1.read() == f2.read(), name


@pytest.mark.parametrize("seed,comment,base", [(0, "%", 1), (1, "#", 0),
                                               (2, "%", 0)])
@pytest.mark.parametrize("chunk", [1, 7, 64, 1 << 20])
def test_ingest_equals_reference(tmp_path, seed, comment, base, chunk):
    path = str(tmp_path / "g.tsv")
    _write(path, _seeded_ops(seed), comment=comment, base=base)
    j = jingest.ingest_edges(path, out_dir=str(tmp_path / "j"),
                             chunk_edges=chunk)
    t = tingest.ingest_edges(path, out_dir=str(tmp_path / "t"),
                             chunk_edges=chunk)
    _assert_same_graph(t, j)
    _assert_same_files(str(tmp_path / "t"), str(tmp_path / "j"))
    g = t.as_graph()
    assert isinstance(g, BipartiteGraph)
    np.testing.assert_array_equal(g.edges, j.as_graph().edges)


def test_cache_written_by_either_package_loads_in_the_other(tmp_path):
    path = str(tmp_path / "g.tsv")
    _write(path, _seeded_ops(3))
    jdir, tdir = str(tmp_path / "by_jax"), str(tmp_path / "by_torch")
    j = jingest.ingest_edges(path, out_dir=jdir)
    t = tingest.ingest_edges(path, out_dir=tdir)
    mtimes = {d: os.path.getmtime(os.path.join(d, "edges.bin"))
              for d in (jdir, tdir)}
    # each package hits the other's cache (same sha, version, chunk size)
    _assert_same_graph(tingest.ingest_edges(path, out_dir=jdir), j)
    _assert_same_graph(jingest.ingest_edges(path, out_dir=tdir), t)
    _assert_same_graph(tingest.load_ingested(jdir), jingest.load_ingested(tdir))
    for d, m in mtimes.items():
        assert os.path.getmtime(os.path.join(d, "edges.bin")) == m, d


def test_ingest_edge_cases_match_reference(tmp_path):
    cases = {
        "cancel": [(5, 100, 1), (5, 100, -1), (7, 100, 1), (7, 100, 1),
                   (9, 200, 1)],
        "empty": [(1, 2, 1), (1, 2, -1)],
        "single": [(0, 0, 1)],
    }
    for name, ops in cases.items():
        path = str(tmp_path / f"{name}.tsv")
        _write(path, ops)
        j = jingest.ingest_edges(path, out_dir=str(tmp_path / f"{name}.j"))
        t = tingest.ingest_edges(path, out_dir=str(tmp_path / f"{name}.t"))
        _assert_same_graph(t, j)


# ------------------------------------------- chunk and order invariance
def _oracle(ops):
    """Reference semantics for a list of (u_raw, v_raw, sign) lines."""
    net = {}
    for u, v, s in ops:
        net[(u, v)] = net.get((u, v), 0) + s
    present = sorted(k for k, n in net.items() if n > 0)
    deg_u, deg_v = {}, {}
    for u, v in present:
        deg_u[u] = deg_u.get(u, 0) + 1
        deg_v[v] = deg_v.get(v, 0) + 1

    def ranks(vocab, deg):
        order = sorted(vocab, key=lambda r: (-deg.get(r, 0), r))
        return {r: i for i, r in enumerate(order) if deg.get(r, 0) > 0}

    ru = ranks({u for u, _, _ in ops}, deg_u)
    rv = ranks({v for _, v, _ in ops}, deg_v)
    return sorted((ru[u], rv[v]) for u, v in present), len(ru), len(rv)


_OPS = st.lists(st.tuples(st.booleans(), st.integers(0, 9),
                          st.integers(0, 7)), min_size=1, max_size=40)


@settings(max_examples=30, deadline=None)
@given(raw_ops=_OPS, rnd=st.randoms(use_true_random=False))
def test_ingest_invariant_to_chunks_and_order(raw_ops, rnd, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ing")
    ops = [(7 * u + 3, 1_000_000 + 13 * v, 1 if ins else -1)
           for ins, u, v in raw_ops]
    p0 = str(tmp / "a.tsv")
    _write(p0, ops)
    ig0 = tingest.ingest_edges(p0, out_dir=str(tmp / "a.ing"))
    edges, n_u, n_v = _oracle(ops)
    assert (ig0.n_u, ig0.n_v, ig0.m) == (n_u, n_v, len(edges))
    assert [tuple(map(int, e)) for e in np.asarray(ig0.edges)] == edges
    for ce in (1, 3):
        igc = tingest.ingest_edges(p0, out_dir=str(tmp / f"c{ce}.ing"),
                                   chunk_edges=ce)
        np.testing.assert_array_equal(np.asarray(igc.edges),
                                      np.asarray(ig0.edges))
    order = list(range(len(ops)))
    rnd.shuffle(order)
    p1 = str(tmp / "b.tsv")
    _write(p1, ops, order=order)
    ig1 = tingest.ingest_edges(p1, out_dir=str(tmp / "b.ing"), chunk_edges=5)
    np.testing.assert_array_equal(np.asarray(ig1.edges), np.asarray(ig0.edges))
    assert (ig1.n_u, ig1.n_v, ig1.m) == (ig0.n_u, ig0.n_v, ig0.m)


# ------------------------------------------------- tiled ≡ untiled ⋈init
def _assert_tiled_equal(got, want):
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]
    assert dataclasses.asdict(got[3]) == dataclasses.asdict(want[3])


@pytest.mark.parametrize("tile_wedges,width", [(700, 512), (10 ** 9, 512),
                                               (2500, 64), (300, 3)])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_tiled_init_equals_reference_and_untiled(tile_wedges, width,
                                                 use_pallas):
    tg = tproxy("fr")
    got = tcsr.tiled_butterfly_init(tg, tile_wedges=tile_wedges,
                                    use_pallas=use_pallas, width=width,
                                    device="cpu")
    want = jcsr.tiled_butterfly_init(jproxy("fr"), tile_wedges=tile_wedges,
                                     width=width)
    if use_pallas:   # the slot-matrix peak exists on the kernel route only
        assert got[3].peak_slot_bytes > 0
        got[3].peak_slot_bytes = 0
    _assert_tiled_equal(got, want)
    w = tcsr.build_wedges(tg)
    np.testing.assert_array_equal(got[0], tcsr.edge_butterflies0(w))
    np.testing.assert_array_equal(got[1], tcsr.vertex_butterflies_csr(w))
    assert got[2] == tcsr.total_butterflies_csr(w)
    if tile_wedges < w.n_wedges:
        assert got[3].n_tiles > 1


def test_tiled_init_kernel_route_equals_reference_pallas_path():
    """Hub tiles (one vertex over the budget) and hub pairs spanning
    several slot rows; TileStats — peak slot bytes included — equal the
    JAX package's Pallas route."""
    kw = dict(tile_wedges=256, use_pallas=True, width=128)
    got = tcsr.tiled_butterfly_init(tpowerlaw(300, 200, 2400, seed=5),
                                    device="cpu", **kw)
    want = jcsr.tiled_butterfly_init(jpowerlaw(300, 200, 2400, seed=5), **kw)
    _assert_tiled_equal(got, want)
    assert got[3].peak_tile_wedges > 256      # a hub tile
    assert got[3].peak_slot_bytes > 0


def test_tile_layout_puts_each_wedge_in_its_pair_row():
    g = tpowerlaw(120, 60, 900, seed=2)
    a, b, _, _ = next(tcsr.iter_wedge_tiles(g, 1 << 20))
    lay = tcsr.tile_layout(a, b, g.n_u, 8, "cpu")
    slots = tcsr.tile_slot_matrix(lay)
    assert slots.shape[1] == 128 and slots.shape[0] >= lay.n_rows
    assert int(slots.sum()) == a.size
    assert int(slots[lay.n_rows:].sum()) == 0
    keys, counts = np.unique(a * g.n_u + b, return_counts=True)
    np.testing.assert_array_equal(lay.keys[lay.pair_start].numpy(), keys)
    np.testing.assert_array_equal(lay.rows_per_pair.numpy(),
                                  -(-counts // 8))


# -------------------------------------------------- end-to-end real graph
def _sha(theta):
    return hashlib.sha256(
        np.asarray(theta, dtype=np.int64).tobytes()).hexdigest()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_real_graph_end_to_end_golden(tmp_path, use_pallas):
    from repro_torch.core.peel import tip_decomposition, wing_decomposition

    with open(os.path.join(HERE, "goldens", "real_graphs.json")) as f:
        want = json.load(f)["southern_women"]
    ig = tingest.ingest_edges(DATASET, out_dir=str(tmp_path / "sw.ing"))
    assert (ig.n_u, ig.n_v, ig.m) == (want["n_u"], want["n_v"], want["m"])
    sup_e, sup_u, total, _ = tcsr.tiled_butterfly_init(
        ig, tile_wedges=64, use_pallas=use_pallas, device="cpu")
    assert total == want["total_butterflies"]
    g = ig.as_graph()
    wing = wing_decomposition(g, engine="csr", sup0=sup_e, device="cpu")
    assert _sha(wing.theta) == want["theta_wing_sha256"]
    tip = tip_decomposition(g, side="u", engine="csr", sup0=sup_u,
                            device="cpu")
    assert _sha(tip.theta) == want["theta_tip_u_sha256"]
