"""The port's csr engine against the JAX package's, array for array.

Host side (numpy copies): wedge lists, butterfly counts, slot packers
and both FD partition packers must be array-equal.  Device side (torch
on the CPU): the incremental updates must equal the reference's on the
same numpy-seeded peel masks — every quantity is an integer, so every
comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core import distributed as jdist
from repro.core import graph as jgraph
from repro.core.peel import tip_decomposition as jtip
from repro.core.peel import wing_decomposition as jwing
from repro_torch.core import csr as tcsr
from repro_torch.core import distributed as tdist
from repro_torch.core import graph as tgraph

# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

GRAPHS = {
    "rb30": ("random_bipartite", (30, 24, 140), dict(seed=0)),
    "pl80": ("powerlaw_bipartite", (80, 40, 350), dict(seed=2)),
    "pl60": ("powerlaw_bipartite", (60, 50, 300), dict(seed=3)),
}


def _graphs(name):
    fn, a, kw = GRAPHS[name]
    return getattr(tgraph, fn)(*a, **kw), getattr(jgraph, fn)(*a, **kw)


def _eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b))


def _eq_dict(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            _eq(a[k], b[k])
            assert a[k].dtype == b[k].dtype, k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_host_wedges_counts_and_slots_match(name):
    tg, jg = _graphs(name)
    tw, jw = tcsr.build_wedges(tg), jcsr.build_wedges(jg)
    for f in ("n_u", "n_v", "m", "n_pairs"):
        assert getattr(tw, f) == getattr(jw, f)
    for f in ("pair_a", "pair_b", "wedge_pair", "wedge_e1", "wedge_e2",
              "W0"):
        _eq(getattr(tw, f), getattr(jw, f))
    _eq(tw.pair_butterflies0(), jw.pair_butterflies0())
    _eq(tcsr.vertex_butterflies_csr(tw), jcsr.vertex_butterflies_csr(jw))
    _eq(tcsr.edge_butterflies0(tw), jcsr.edge_butterflies0(jw))
    assert tcsr.total_butterflies_csr(tw) == jcsr.total_butterflies_csr(jw)
    for a, b in zip(tcsr.wedge_workload(tg), jcsr.wedge_workload(jg)):
        _eq(a, b)
    tp, jp = tcsr.pack_wedge_slots(tw), jcsr.pack_wedge_slots(jw)
    assert (tp.n_rows, tp.n_rows_pad, tp.width) == (
        jp.n_rows, jp.n_rows_pad, jp.width)
    _eq(tp.idx, jp.idx)
    _eq(tp.valid, jp.valid)
    _eq_dict(tcsr.pack_update_slots(tw), jcsr.pack_update_slots(jw))
    bf0 = jw.pair_butterflies0()
    _eq_dict(tcsr.pack_tip_slots(tw, bf0), jcsr.pack_tip_slots(jw, bf0))
    for a, b in zip(tcsr.directed_pair_incidence(tw, bf0),
                    jcsr.directed_pair_incidence(jw, bf0)):
        _eq(a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fd_packers_match(name):
    tg, jg = _graphs(name)
    tw, jw = tcsr.build_wedges(tg), jcsr.build_wedges(jg)
    res = jwing(jg, P=4, engine="csr")
    n = int(res.part.max()) + 1
    for kw in (dict(), dict(bucket=True, flat=True),
               dict(bucket=True, slots=True), dict(slots=True, flat=True)):
        _eq_dict(tdist.pack_fd_partitions_csr(tw, res.part,
                                              res.support_init, n, **kw),
                 jdist.pack_fd_partitions_csr(jw, res.part,
                                              res.support_init, n, **kw))
    res = jtip(jg, side="u", P=4, engine="csr")
    n = int(res.part.max()) + 1
    bf0 = jw.pair_butterflies0()
    for kw in (dict(), dict(bucket=True), dict(bucket=True, stacked=True)):
        _eq_dict(tdist.pack_fd_partitions_tip_csr(
            tw, bf0, res.part, res.support_init, n, **kw),
            jdist.pack_fd_partitions_tip_csr(
                jw, bf0, res.part, res.support_init, n, **kw))


def _mask(n, seed, p=0.3):
    return np.random.default_rng(seed).random(n) < p


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tip_deltas_match(name, seed):
    tg, jg = _graphs(name)
    w = jcsr.build_wedges(jg)
    bf = w.pair_butterflies0().astype(np.int32)
    peel = _mask(w.n_u, seed)
    want = jcsr.tip_delta_csr(jnp.asarray(peel), jnp.asarray(w.pair_a),
                              jnp.asarray(w.pair_b), jnp.asarray(bf), w.n_u)
    got = tcsr.tip_delta_csr(torch.from_numpy(peel),
                             torch.from_numpy(w.pair_a),
                             torch.from_numpy(w.pair_b),
                             torch.from_numpy(bf), w.n_u)
    _eq(got, want)
    assert got.dtype == torch.int32
    slots = jcsr.pack_tip_slots(w, w.pair_butterflies0())
    want_s = jcsr.tip_delta_slots(
        jnp.asarray(peel), jnp.asarray(slots["partner"]),
        jnp.asarray(slots["bf"]), w.n_u, interpret=True)
    got_s = tcsr.tip_delta_slots(
        torch.from_numpy(peel), torch.from_numpy(slots["partner"]),
        torch.from_numpy(slots["bf"]), w.n_u)
    _eq(got_s, want_s)
    _eq(got_s, got)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_wing_updates_match(name, seed):
    tg, jg = _graphs(name)
    w = jcsr.build_wedges(jg)
    m = w.m
    peel = _mask(m, seed, p=0.2)
    alive_w = _mask(w.n_wedges, seed + 10, p=0.8)
    alive_e = ~_mask(m, seed + 20, p=0.1)
    W = np.array(jcsr.pair_wedge_counts(w, jnp.asarray(alive_e)))
    sup = jcsr.edge_butterflies0(w).astype(np.int32)
    j = [jnp.asarray(x) for x in (w.wedge_e1, w.wedge_e2, w.wedge_pair)]
    t = [torch.from_numpy(x) for x in (w.wedge_e1, w.wedge_e2, w.wedge_pair)]
    want = jcsr.wing_update_csr(jnp.asarray(peel), jnp.asarray(alive_w),
                                jnp.asarray(W), jnp.asarray(sup), *j,
                                w.n_pairs, m)
    got = tcsr.wing_update_csr(torch.from_numpy(peel),
                               torch.from_numpy(alive_w),
                               torch.from_numpy(W), torch.from_numpy(sup),
                               *t, w.n_pairs, m)
    for a, b in zip(got, want):
        _eq(a, b)

    slots = jcsr.pack_update_slots(w)
    valid = slots["valid"] & _mask(slots["valid"].size, seed + 30,
                                   p=0.9).reshape(slots["valid"].shape)
    Wv = valid.sum(axis=1)[:w.n_pairs].astype(np.int32)
    want = jcsr.wing_update_slots(
        jnp.asarray(peel), jnp.asarray(valid), jnp.asarray(Wv),
        jnp.asarray(sup), jnp.asarray(slots["e1"]), jnp.asarray(slots["e2"]),
        w.n_pairs, m, interpret=True)
    got = tcsr.wing_update_slots(
        torch.from_numpy(peel), torch.from_numpy(valid),
        torch.from_numpy(Wv), torch.from_numpy(sup),
        torch.from_numpy(slots["e1"]), torch.from_numpy(slots["e2"]),
        w.n_pairs, m)
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pair_wedge_counts_match(name):
    tg, jg = _graphs(name)
    tw, jw = tcsr.build_wedges(tg), jcsr.build_wedges(jg)
    alive = ~_mask(jw.m, 3, p=0.25)
    want = jcsr.pair_wedge_counts(jw, jnp.asarray(alive))
    for use_pallas in (False, True):
        got = tcsr.pair_wedge_counts(tw, torch.from_numpy(alive),
                                     use_pallas=use_pallas)
        _eq(got, want)
        assert got.dtype == torch.int32
    _eq(tcsr.pair_wedge_counts(tw, device="cpu"), jcsr.pair_wedge_counts(jw))
