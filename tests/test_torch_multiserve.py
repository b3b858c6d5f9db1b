"""The port's multi-tenant hierarchy service (``ForestPool``,
``MultiTenantService``, ``launch/hserve.py``) against the JAX package's,
live, on the small artifacts of ``tests/test_multiserve.py``.

* mixed-tenant mixed-op batches answer bit for bit as the JAX service
  and as a per-tenant ``HierarchyService``, with artifacts written by
  either package;
* every test of ``tests/test_multiserve.py`` mirrored: the submit/run
  round trip, validation against the tenants' true dims, the dispatch
  count (the port's counted signatures equal JAX's
  ``compiled_dispatch_count()`` after the same sequence), LRU order,
  pinned and queued tenants, ``PoolFull``, evict and reload, v1 and v2
  artifacts and the version checks;
* what the port adds: buckets whose node and entity paddings differ
  (every gather stays in range), ``slot_upload=False`` against the
  default, telemetry off against on, the metrics' key set, the CLI's
  ``--out`` and lines against ``repro.launch.hserve``, ``--dryrun
  --device cpu``, SIGINT, the golden ``torch_multiserve.json`` and
  ``chip_smoke.py``'s multitenant phase rehearsed at a small size.
"""
import importlib.util
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro import hierarchy as jh
from repro.core.graph import powerlaw_bipartite as jpowerlaw
from repro.core.peel import wing_decomposition as jwing
from repro.hierarchy import multiserve as jms
from repro.launch import hserve as jcli
from repro_torch import hierarchy as th
from repro_torch import obs as tobs
from repro_torch.core.graph import powerlaw_bipartite as tpowerlaw
from repro_torch.core.peel import tip_decomposition as ttip
from repro_torch.core.peel import wing_decomposition as twing
from repro_torch.hierarchy import multiserve as tms
from repro_torch.launch import hserve as tcli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = th.OPS
BIG = dict(nu=40, nv=28, m=120)
SMALL = dict(nu=12, nv=8, m=24)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jhier(nu=40, nv=28, m=120, seed=0):
    g = jpowerlaw(nu, nv, m, seed=seed)
    return jh.build_hierarchy(g, jwing(g, P=4, engine="csr"))


def _thier(nu=40, nv=28, m=120, seed=0):
    g = tpowerlaw(nu, nv, m, seed=seed)
    return th.build_hierarchy(
        g, twing(g, P=4, engine="csr", device="cpu"), device="cpu")


def _write(d, make, save):
    """``tests/test_multiserve.py``'s six artifacts: big0..big3 (one
    bucket) and small0..small1 (another)."""
    d.mkdir()
    for i in range(4):
        save(str(d / f"big{i}.npz"), make(**BIG, seed=i))
    for i in range(2):
        save(str(d / f"small{i}.npz"), make(**SMALL, seed=10 + i))
    return str(d)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The same six tenants written by each package."""
    root = tmp_path_factory.mktemp("mt")
    return dict(jax=_write(root / "jax", _jhier, jh.save_hierarchy),
                torch=_write(root / "torch", _thier, th.save_hierarchy))


def _services(d, slots=8, batch=64, **kw):
    """A JAX and a port (pool, service) pair over one artifact dir."""
    jp = jh.ForestPool(slots=slots, artifact_dir=d, **kw)
    tp = th.ForestPool(slots=slots, artifact_dir=d, device="cpu", **kw)
    return ((jp, jh.MultiTenantService(jp, batch=batch)),
            (tp, th.MultiTenantService(tp, batch=batch)))


def _workload(pool, tenants, n, seed):
    for t in tenants:
        pool.ensure(t)
    return tcli._mixed_workload(pool, tenants, n, seed=seed)


def _oracle(d, tenants, ops, a, b):
    """Each slot through its tenant's own port ``HierarchyService``: one
    batched call per tenant."""
    want = np.full(len(tenants), -2, np.int32)
    names = np.asarray(tenants)
    for t in dict.fromkeys(tenants):
        m = names == t
        svc = th.HierarchyService(
            th.load_hierarchy(os.path.join(d, f"{t}.npz")), device="cpu")
        want[m] = svc.query_batch(ops[m], a[m], b[m])
    return want


# ------------------------------------------------------------ oracle parity
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_mixed_tenant_batch_equals_reference(dirs, writer):
    """The tentpole claim: the pooled dispatch answers as the JAX
    package's and as a per-tenant service, bit for bit, whichever
    package wrote the artifacts."""
    d = dirs[writer]
    (jp, js), (tp, ts) = _services(d)
    active = ["big0", "big1", "big2", "small0", "small1"]
    tenants, ops, a, b = _workload(tp, active, 400, seed=1)
    _workload(jp, active, 0, seed=1)
    got = ts.query_batch(tenants, ops, a, b)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, js.query_batch(tenants, ops, a, b))
    np.testing.assert_array_equal(got, _oracle(d, tenants, ops, a, b))
    assert ts.dispatches == js.dispatches


def test_submit_run_roundtrip(dirs):
    (jp, js), (tp, ts) = _services(dirs["torch"], batch=32)
    for svc, Q in ((js, jh.MTQuery), (ts, th.MTQuery)):
        svc.submit(Q(uid=7, tenant="big0", op="max_k", a=3))
        svc.submit(Q(uid=1, tenant="big0", op="lca_level", a=1, b=5))
        svc.submit(Q(uid=4, tenant="small1", op="subtree_size", a=0))
        assert svc.pending() == 3
    want = [(q.uid, q.result, q.done) for q in js.run()]
    got = [(q.uid, q.result, q.done) for q in ts.run()]
    assert got == want and [u for u, _, _ in got] == [1, 4, 7]
    assert all(m.queued == 0 for m in tp.meta.values())
    assert ts.pending() == 0 and ts.run() == []


def _raises(fn):
    try:
        fn()
    except (ValueError, KeyError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", ["max_k_past_entities", "lca_b_past",
                                  "subtree_past_nodes", "negative",
                                  "op_code", "submit_unknown_op"])
def test_validation_uses_true_dims_like_reference(dirs, case):
    """An id inside the padded bucket but past the tenant's real range
    is refused on the host, with the JAX package's exception and text;
    so is an unknown op."""
    (jp, js), (tp, ts) = _services(dirs["torch"], batch=32)
    jp.ensure("small0")
    tp.ensure("small0")
    m = tp.meta["small0"]
    cols = {"max_k_past_entities": (OPS["max_k"], m.n_entities, 0),
            "lca_b_past": (OPS["lca_level"], 1, m.n_entities),
            "subtree_past_nodes": (OPS["subtree_size"], m.n_nodes, 0),
            "negative": (OPS["node_of"], -1, 0),
            "op_code": (9, 0, 0)}
    if case == "submit_unknown_op":
        calls = [lambda s=s, Q=Q: s.submit(Q(uid=0, tenant="small0",
                                            op="nope", a=0))
                 for s, Q in ((js, jh.MTQuery), (ts, th.MTQuery))]
    else:
        op, a, b = cols[case]
        # a valid slot first: the first failing slot is the one reported
        arr = [np.asarray(x, np.int32) for x in ([0, op], [0, a], [0, b])]
        calls = [lambda s=s: s.query_batch(["small0"] * 2, *arr)
                 for s in (js, ts)]
    want, got = _raises(calls[0]), _raises(calls[1])
    assert want is not None and got == want
    assert all(x.queued == 0 for x in tp.meta.values())


# ---------------------------------------------- signature-count invariants
def test_dispatch_signatures_equal_reference(dirs):
    """The port counts one dispatch signature per (bucket shape,
    capacity, J, batch) — what JAX's jit cache keys on — so after the
    same admissions and traffic it equals ``compiled_dispatch_count()``:
    one per bucket, unchanged by cold same-bucket loads (the sequence of
    ``test_one_compile_per_bucket_and_zero_retrace_cold_load``), and one
    more for a bucket that grew (the golden's recipe)."""
    jms._answer_batch_multi._clear_cache()
    tms.reset_dispatch_count()
    assert tms.compiled_dispatch_count() == 0
    (jp, js), (tp, ts) = _services(dirs["torch"])
    counts = []
    for tenants, seed in ((["big0", "big1", "small0"], 1),
                          (["big0", "big1", "big2", "big3", "small0",
                            "small1"], 2)):
        t_col, ops, a, b = _workload(tp, tenants, 400, seed)
        _workload(jp, tenants, 0, seed)
        np.testing.assert_array_equal(ts.query_batch(t_col, ops, a, b),
                                      js.query_batch(t_col, ops, a, b))
        counts.append((tms.compiled_dispatch_count(),
                       jms.compiled_dispatch_count(), len(tp.buckets)))
    # the port's count, JAX's and the bucket count, after each traffic
    assert counts == [(n, n, n) for _, _, n in counts]

    rec = _load("record_torch_multiserve", os.path.join(
        ROOT, "tests", "goldens", "record_torch_multiserve.py"))
    recipe = rec.RECIPE
    d = os.path.join(str(dirs["torch"]), "..", "recipe")
    os.makedirs(d, exist_ok=True)
    rec.write_jax_tenants(recipe, d)
    want = rec.record_jax(recipe, d)
    tms.reset_dispatch_count()
    pool = th.ForestPool(slots=recipe["slots"], artifact_dir=d, device="cpu")
    got = rec.replay(recipe, pool, th.MultiTenantService(
        pool, batch=recipe["batch"]), tcli._mixed_workload)
    got["compiled_dispatch_count"] = tms.compiled_dispatch_count()
    assert got == want
    assert want["compiled_dispatch_count"] == len(want["buckets"]) + 1


def test_cold_same_bucket_load_moves_nothing(dirs):
    """Admitting a cold tenant into a free slot of a device-resident
    bucket: no new signature, the bucket's tensors keep their storage
    and values change in place, no bucket re-upload — the counterpart
    of JAX's zero retraces."""
    tms.reset_dispatch_count()
    pool = th.ForestPool(slots=8, artifact_dir=dirs["torch"], device="cpu")
    svc = th.MultiTenantService(pool, batch=64)
    svc.query_batch(*_workload(pool, ["big0", "big1"], 100, seed=0))
    key = pool.meta["big0"].bucket
    arrs = pool.bucket_arrays(key)
    ptrs = {n: x.data_ptr() for n, x in arrs.items()}
    n_sig = tms.compiled_dispatch_count()
    uploads = pool.metrics.get("pool.bucket_upload_ms").count
    t_col, ops, a, b = _workload(pool, ["big3", "big0"], 100, seed=1)
    assert pool.meta["big3"].bucket == key
    got = svc.query_batch(t_col, ops, a, b)
    assert tms.compiled_dispatch_count() == n_sig
    assert {n: x.data_ptr()
            for n, x in pool.bucket_arrays(key).items()} == ptrs
    assert pool.metrics.get("pool.bucket_upload_ms").count == uploads
    assert pool.metrics.get("pool.admission_upload_ms").count == 1
    for name, host in pool.buckets[key].host.items():
        np.testing.assert_array_equal(arrs[name].numpy(), host)
    np.testing.assert_array_equal(
        got, _oracle(dirs["torch"], t_col, ops, a, b))


# ------------------------------------------------------- LRU + eviction
def _lru(pool, svc, PoolFull):
    pool.ensure("big0")
    pool.ensure("big1")
    # traffic touches big0 AFTER big1's admission → big1 is now LRU
    svc.query_batch(["big0"], np.asarray([OPS["max_k"]], np.int32),
                    np.asarray([0], np.int32))
    pool.ensure("big2")                      # must evict big1, not big0
    return [sorted(pool.tenants()), pool.stats()["evictions"]]


def _pinned(pool, svc, PoolFull):
    pool.pin("big0")
    for t in ("big1", "big2", "big3"):
        pool.ensure(t)
    obs = [sorted(pool.tenants()), _raises(lambda: pool.evict("big0"))]
    pool.unpin("big0")
    pool.ensure("small0")                    # now big0 is fair game
    return obs + [sorted(pool.tenants())]


def _queued(pool, svc, PoolFull):
    pool.ensure("big0")
    pool.note_queued("big0", +1)
    try:
        pool.ensure("big1")
        full = None
    except PoolFull as e:
        full = str(e)
    obs = [full, _raises(lambda: pool.evict("big0"))]
    pool.note_queued("big0", -1)
    pool.ensure("big1")                      # retired batch → evictable
    return obs + [sorted(pool.tenants())]


def _same_batch(pool, svc, PoolFull):
    pool.ensure("big0")
    ops = np.asarray([OPS["max_k"]] * 2, np.int32)
    z = np.zeros(2, np.int32)
    try:
        svc.query_batch(["big0", "big1"], ops, z, z)
        full = None
    except PoolFull as e:
        full = str(e)
    return [full, pool.resident("big0"),
            [m.queued for m in pool.meta.values()]]


SCENARIOS = {"lru": (2, _lru), "pinned": (2, _pinned),
             "queued_poolfull": (1, _queued),
             "admission_spares_same_batch": (1, _same_batch)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_eviction_semantics_equal_reference(dirs, name):
    """LRU order under interleaved traffic, pinned and queued tenants,
    ``PoolFull`` and its text: each scenario of ``test_multiserve.py``
    run on both packages, every observation equal, and the stats."""
    slots, scenario = SCENARIOS[name]
    (jp, js), (tp, ts) = _services(dirs["torch"], slots=slots, batch=16)
    want = scenario(jp, js, jh.PoolFull)
    got = scenario(tp, ts, th.PoolFull)
    assert got == want
    assert {k: v for k, v in tp.stats().items() if k != "load_seconds"} == \
        {k: v for k, v in jp.stats().items() if k != "load_seconds"}
    expect = {"lru": [["big0", "big2"], 1],
              "admission_spares_same_batch": [want[0], True, [0]]}
    if name in expect:
        assert got == expect[name]
    if name in ("queued_poolfull", "admission_spares_same_batch"):
        assert got[0] is not None and "raise --pool-slots" in got[0]


def test_evict_reload_answers_bit_identical(dirs):
    """A tenant evicted and re-admitted (another slot, a grown bucket)
    answers as a pool that never evicted it, and as the JAX pool that
    thrashed the same way."""
    answers = []
    tenants_ops = None
    for slots in (8, 3):
        (jp, js), (tp, ts) = _services(dirs["torch"], slots=slots,
                                       batch=32)
        if tenants_ops is None:
            tenants_ops = _workload(tp, ["big0", "big1", "big2"], 120, 3)
        if slots == 3:
            for pool in (jp, tp):
                for t in ("big0", "big1", "big2", "big3", "big0"):
                    pool.ensure(t)
            assert tp.stats()["evictions"] == jp.stats()["evictions"] >= 2
        got = ts.query_batch(*tenants_ops)
        np.testing.assert_array_equal(got, js.query_batch(*tenants_ops))
        answers.append(got)
    np.testing.assert_array_equal(answers[0], answers[1])


# --------------------------------------------------- artifact versions
def test_v1_and_v2_tenants_serve_identically(tmp_path):
    """Artifacts written before the pack cache existed load through the
    v1 branch and serve as v2 ones, in the port as in the JAX package,
    and both versions pack equal forests."""
    d = str(tmp_path)
    h = _thier(seed=5)
    th.save_hierarchy(os.path.join(d, "v1t.npz"), h, version=1)
    th.save_hierarchy(os.path.join(d, "v2t.npz"), h)
    h1 = th.load_hierarchy(os.path.join(d, "v1t.npz"))
    h2 = th.load_hierarchy(os.path.join(d, "v2t.npz"))
    assert "pack_up" not in h1.meta
    assert h2.meta["pack_up"].shape[0] == h.n_nodes
    f1, f2 = th.pack_forest(h1, device="cpu"), th.pack_forest(h2, device="cpu")
    assert torch.equal(f1.up, f2.up) and torch.equal(f1.depth, f2.depth)
    (jp, js), (tp, ts) = _services(d, slots=4, batch=16)
    t_col, ops, a, b = _workload(tp, ["v1t"], 60, seed=4)
    got1 = ts.query_batch(t_col, ops, a, b)
    got2 = ts.query_batch(["v2t"] * len(t_col), ops, a, b)
    np.testing.assert_array_equal(got1, got2)
    np.testing.assert_array_equal(got1, js.query_batch(t_col, ops, a, b))


def test_format_version_checks(tmp_path):
    assert th.FORMAT_VERSION == jh.FORMAT_VERSION == 2
    with pytest.raises(ValueError, match="cannot write"):
        th.save_hierarchy(str(tmp_path / "x.npz"), _thier(**SMALL),
                          version=99)
    pool = th.ForestPool(slots=2, artifact_dir=str(tmp_path), device="cpu")
    with pytest.raises(KeyError, match="no artifact"):
        pool.ensure("absent")
    with pytest.raises(KeyError, match="no artifact_dir"):
        th.ForestPool(slots=2, device="cpu").ensure("absent")
    with pytest.raises(ValueError, match="at least one slot"):
        th.ForestPool(slots=0, device="cpu")


# ------------------------------------------------- what the port adds
def _chain(pkg, n_nodes=20, n_ent=3):
    """A hand-made forest with more nodes than entities — a chain of
    ``n_nodes`` nodes, every entity in the deepest — so its bucket's
    node padding exceeds its entity padding (a built forest collapses
    chains, so it never has more nodes than entities)."""
    i64 = np.int64
    ids = np.arange(n_nodes)
    ent = np.arange(n_ent)
    return pkg.Hierarchy(
        kind="wing", n_entities=n_ent,
        theta=np.full(n_ent, n_nodes - 1, i64),
        node_level=ids.astype(i64), parent=(ids - 1).astype(np.int32),
        entity_node=np.full(n_ent, n_nodes - 1, np.int32),
        member_off=np.r_[np.zeros(n_nodes, i64), n_ent],
        member_ids=ent.astype(np.int32),
        child_off=np.r_[0, np.arange(1, n_nodes), n_nodes - 1].astype(i64),
        child_ids=ids[1:].astype(np.int32),
        tin=ids.astype(np.int32), tout=np.full(n_nodes, n_nodes, np.int32),
        ent_order=ent.astype(np.int32), estart=np.zeros(n_nodes, i64),
        eend=np.full(n_nodes, n_ent, i64), node_m=np.zeros(n_nodes, i64),
        node_nu=np.zeros(n_nodes, i64), node_nv=np.zeros(n_nodes, i64),
        density=np.zeros(n_nodes), meta={})


def test_padding_mismatch_buckets_answer_in_range():
    """Every answer family is computed for every slot; an id of one
    family's table can run past another's padding (a node id past the
    entity padding, an entity id past the node padding).  JAX clamps
    those gathers; the port clamps each family's ids into its own table,
    so it raises nowhere (on the card it would be a device-side assert)
    and every answer equals JAX's."""
    pools = []
    for pkg in (jh, th):
        kw = {} if pkg is jh else dict(device="cpu")
        pool = pkg.ForestPool(slots=4, **kw)
        pool.add("chain", _chain(pkg))
        pool.add("wing", _jhier(**BIG) if pkg is jh else _thier(**BIG))
        pools.append((pool, pkg.MultiTenantService(pool, batch=64)))
    (jp, js), (tp, ts) = pools
    chain, wing = tp.meta["chain"], tp.meta["wing"]
    assert chain.bucket[0] > chain.bucket[1]      # nodes pad past entities
    assert wing.bucket[1] > wing.bucket[0]        # entities pad past nodes
    assert chain.n_nodes > chain.bucket[1] and wing.n_entities > \
        wing.bucket[0]
    t_col, ops, a, b = [], [], [], []
    for t, m in (("chain", chain), ("wing", wing)):
        for op, code in OPS.items():
            lim = m.n_nodes if op == "subtree_size" else m.n_entities
            for x in range(lim):
                t_col.append(t)
                ops.append(code)
                a.append(x)
                b.append((x * 7) % m.n_entities)
    ops, a, b = (np.asarray(v, np.int32) for v in (ops, a, b))
    got = ts.query_batch(t_col, ops, a, b)
    np.testing.assert_array_equal(got, js.query_batch(t_col, ops, a, b))
    sub = (np.asarray(t_col) == "chain") & (ops == OPS["subtree_size"])
    assert (a[sub] >= chain.bucket[1]).any() and (got[sub] == 3).all()


def test_slot_upload_off_answers_as_on(dirs):
    """``slot_upload=False`` (the whole-bucket re-upload) and the default
    per-slot copy leave equal device tensors, equal to the host mirror,
    and answer the same; each path times its own metric."""
    arrs, answers, pools = {}, {}, {}
    for mode, su in (("slot", True), ("bucket", False)):
        pool = th.ForestPool(slots=8, artifact_dir=dirs["torch"],
                             slot_upload=su, device="cpu")
        svc = th.MultiTenantService(pool, batch=32)
        pool.ensure("big0")
        for key in list(pool.buckets):
            pool.bucket_arrays(key)          # device-resident before admit
        pool.ensure("big1")
        answers[mode] = svc.query_batch(*_workload(
            pool, ["big0", "big1"], 80, seed=7))
        arrs[mode] = {n: x.clone() for n, x in
                      pool.bucket_arrays(pool.meta["big0"].bucket).items()}
        pools[mode] = pool
    np.testing.assert_array_equal(answers["slot"], answers["bucket"])
    for name in arrs["slot"]:
        assert torch.equal(arrs["slot"][name], arrs["bucket"][name])
    for bucket in pools["slot"].buckets.values():
        for name, host in bucket.host.items():
            np.testing.assert_array_equal(bucket.device[name].numpy(), host)
    assert pools["slot"].metrics.get("pool.admission_upload_ms").count == 1
    assert pools["bucket"].metrics.get("pool.admission_upload_ms") is None
    assert pools["bucket"].metrics.get("pool.bucket_upload_ms").count >= 2


def _aten_ops(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e.name for e in prof.events()
                 if e.name.startswith("aten::")]


def test_telemetry_off_and_on_same_answers_and_dispatch_ops(dirs):
    """The serve spans and metrics are host-side only: with the layer on,
    the answers and the dispatch's aten op list equal the layer off; on,
    ``serve.dispatch`` spans count the dispatches and ``pool.cold_load``
    spans the misses."""
    results = {}
    for on in (False, True):
        tracer = tobs.enable() if on else None
        try:
            pool = th.ForestPool(slots=8, artifact_dir=dirs["torch"],
                                 device="cpu")
            svc = th.MultiTenantService(pool, batch=64)
            work = _workload(pool, ["big0", "small0", "big3"], 150, seed=2)
            results[on] = _aten_ops(lambda: svc.query_batch(*work))
        finally:
            tobs.disable()
        if on:
            names = [e["name"] for e in tracer.spans(cat="serve")]
            assert names.count("serve.dispatch") == svc.dispatches
            assert names.count("pool.cold_load") == pool.misses == 3
    np.testing.assert_array_equal(results[False][0], results[True][0])
    assert results[False][1] == results[True][1]
    bad = {"aten::item", "aten::_local_scalar_dense", "aten::nonzero"}
    assert not bad & set(results[False][1])


def _metrics_sequence(pkg, d, **kw):
    """``test_obs.py``'s LRU oracle sequence, then mixed traffic."""
    pool = pkg.ForestPool(slots=3, artifact_dir=d, **kw)
    for t in ("big0", "big1", "big2", "big0", "big1", "big3", "small0",
              "big2"):
        pool.ensure(t)
    svc = pkg.MultiTenantService(pool, batch=32)
    n = 80
    rng = np.random.default_rng(0)
    tenants = [("big2", "small0")[i % 2] for i in range(n)]
    svc.query_batch(tenants, np.zeros(n, np.int32),
                    rng.integers(0, 10, n).astype(np.int32))
    svc.metrics.set_gauge("serve.qps", 1.0)
    return pool, svc.metrics.snapshot()


def test_metrics_snapshot_equals_reference(dirs):
    """The same ``pool.*`` / ``serve.*`` names as the JAX package, every
    counter and gauge equal, every histogram with as many samples."""
    jpool, want = _metrics_sequence(jh, dirs["torch"])
    pool, got = _metrics_sequence(th, dirs["torch"], device="cpu")
    assert sorted(got) == sorted(want)
    for name, snap in want.items():
        if snap["type"] == "histogram":
            assert got[name]["count"] == snap["count"], name
        else:
            assert got[name] == snap, name
    assert (pool.hits, pool.misses, pool.evictions) == \
        (jpool.hits, jpool.misses, jpool.evictions)
    assert pool.evictions > 0


# ------------------------------------------------------------------ CLI
_TIMES = re.compile(r"[0-9.]+ ms|[0-9,]+ q/s|'load_seconds': [0-9.e-]+")


def _cli_lines(text):
    return [_TIMES.sub("<t>", ln) for ln in text.splitlines()
            if ln.startswith("[hserve")]


def test_cli_out_and_lines_equal_reference(dirs, tmp_path, monkeypatch,
                                           capsys):
    """``repro_torch.launch.hserve`` and ``repro.launch.hserve`` on the
    same artifacts: the same ``--out`` JSON but for the clocks (qps,
    load seconds), the same printed lines but for the times, and a
    metrics snapshot with the same names."""
    outs = {}
    for pkg in ("torch", "jax"):
        # each CLI's own process would start with no signature seen
        jms._answer_batch_multi._clear_cache()
        tms.reset_dispatch_count()
        (tmp_path / pkg).mkdir()
        out, met = (str(tmp_path / pkg / f"{k}.json")
                    for k in ("out", "metrics"))
        flags = ["--artifact-dir", dirs["jax"], "--pool-slots", "4",
                 "--batch", "64", "--queries", "1500", "--seed", "3",
                 "--out", out, "--metrics", met]
        if pkg == "torch":
            assert tcli.main([*flags, "--device", "cpu"]) == 0
        else:
            monkeypatch.setattr(sys, "argv", ["repro.launch.hserve",
                                              *flags])
            with pytest.raises(SystemExit) as ex:
                jcli.main()
            assert ex.value.code == 0
        with open(out) as f, open(met) as g:
            outs[pkg] = (json.load(f), sorted(json.load(g)), [
                ln.replace(str(tmp_path / pkg), "<d>")
                for ln in _cli_lines(capsys.readouterr().out)])
    (tout, tmet, tlines), (jout, jmet, jlines) = outs["torch"], outs["jax"]
    for d in (tout, jout):
        d.pop("qps")
        d.pop("load_seconds")
    assert tout == jout and tout["served"] == 1500
    assert tmet == jmet
    assert tlines == jlines and len(tlines) == 4


def test_cli_dryrun_cpu(capsys):
    assert tcli.main(["--dryrun", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[hserve-dryrun]")]
    assert len(lines) == 4 and all(ln.endswith("✓") for ln in lines)
    assert "ONE dispatch signature per bucket" in lines[0]
    assert "no host synchronisation" in lines[2]


def test_cuda_is_the_default_and_never_falls_back(monkeypatch, dirs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        th.ForestPool(slots=2)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["--artifact-dir", dirs["torch"], "--queries", "10"])
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["--dryrun"])


def test_hserve_sigint_graceful_exit(dirs, tmp_path):
    """SIGINT mid-serve: drains, flushes metrics and the trace, exits 0;
    the snapshot's cache counts match ``--out`` (``test_obs.py``'s
    subprocess test, on the port's CLI)."""
    paths = {k: str(tmp_path / f"{k}.json")
             for k in ("metrics", "out", "trace")}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["PYTHONUNBUFFERED"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.hserve",
         "--artifact-dir", dirs["torch"], "--pool-slots", "4",
         "--batch", "64", "--queries", "2000000", "--device", "cpu",
         *(x for k, p in paths.items() for x in (f"--{k}", p))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        head = []
        for line in proc.stdout:         # unbuffered: arrives live
            head.append(line)
            if "warmed" in line:
                break
        assert any("warmed" in ln for ln in head), "".join(head)
        time.sleep(0.5)
        proc.send_signal(signal.SIGINT)
        stdout, stderr = proc.communicate(timeout=300)
        stdout = "".join(head) + stdout
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (stdout[-2000:], stderr[-2000:])
    assert "shutdown signal: queue drained" in stdout
    with open(paths["out"]) as f:
        oracle = json.load(f)
    assert oracle["served"] < 2_000_000
    with open(paths["metrics"]) as f:
        snap = json.load(f)
    for key in ("hits", "misses", "evictions"):
        assert snap.get(f"pool.{key}", {}).get("value", 0) == oracle[key]
    assert snap["pool.resident"]["value"] == oracle["resident"]
    assert "serve.qps" in snap
    with open(paths["trace"]) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"serve.warm", "pool.cold_load"} <= names


# ------------------------------------------- golden and chip_smoke phase
@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(ROOT, "tests", "goldens",
                           "torch_multiserve.json")) as f:
        return json.load(f)


def test_golden_replays_on_cpu(smoke, golden, tmp_path):
    """``chip_smoke.py``'s golden check on the CPU: the port replays
    ``torch_multiserve.json``'s recipe to every recorded field, and a
    wrong recorded value is caught."""
    rec = _load("record_torch_multiserve", os.path.join(
        ROOT, "tests", "goldens", "record_torch_multiserve.py"))
    assert golden["recipe"] == json.loads(json.dumps(rec.RECIPE))
    got = smoke.multiserve_golden(golden, "cpu", str(tmp_path))
    assert got["stats"]["evictions"] > 0 and len(got["buckets"]) >= 2
    assert any(b["cap"] > 4 for b in got["buckets"].values())
    bad = dict(golden, stats=dict(golden["stats"], hits=0))
    with pytest.raises(AssertionError, match="multiserve golden"):
        smoke.multiserve_golden(bad, "cpu", str(tmp_path / "bad"))


def test_chip_smoke_multitenant_phase_rehearsed_on_cpu(smoke, golden,
                                                       tmp_path):
    """Phase 11 on the CPU at a small size (fewer, smaller tenants and
    queries; stand-ins for phase 7's artifacts): the golden, the peels
    held to the plain rounds' peels, the stream at both batch sizes
    against the per-tenant oracle with its signature and pinned checks,
    the upload A/B, the yardstick, the CLI and its dry-run in their own
    processes."""
    arts = {}
    for name, kind, shape in (("tip-1m", "tip", (60, 30, 300)),
                              ("wing-60k", "wing", (50, 30, 200)),
                              ("tip-60k", "tip", (24, 12, 90)),
                              ("southern_women-wing", "wing", (18, 14, 89)),
                              ("southern_women-tip", "tip", (18, 14, 89))):
        g = tpowerlaw(*shape, alpha=0.6, seed=0)
        peel = ttip if kind == "tip" else twing
        h = th.build_hierarchy(g, peel(g, P=4, engine="csr", device="cpu"),
                               kind=kind, device="cpu")
        arts[name] = str(tmp_path / f"{name}.npz")
        th.save_hierarchy(arts[name], h)
    mt = dict(smoke.MT, seeds=2, P=4, tenants=14, slots=9, queries=2_000,
              segments=4, window=4, stride=3, batches=(64, 256),
              cli_batch=256, cli_queries=3_000,
              graphs=dict(tip=dict(n_u=40, n_v=20, m=160, alpha=0.6),
                          wing=dict(n_u=30, n_v=20, m=120, alpha=0.6)))
    info = smoke.phase_multitenant(golden, arts, "cpu", str(tmp_path),
                                   "cpu", mt=mt)
    assert info["launches"] == {}            # plain versions on the CPU
    cold, warm = info["serve"]
    assert cold["stats"]["misses"] > 0 and warm["stats"]["evictions"] > 0
    assert warm["signatures"] == warm["buckets"] >= 4
    assert info["cli"]["stats"]["misses"] == mt["slots"]
    assert info["upload_ab"]["slot"]["admission_upload_ms"]["count"] > 0
    assert info["upload_ab"]["bucket"]["bucket_upload_ms"]["count"] > 0


@pytest.mark.parametrize("kind", ["tip", "wing"])
def test_chip_smoke_mt_peel_catches_a_wrong_fused_round(smoke, kind,
                                                        monkeypatch):
    """Phase 11's peels are held to the plain rounds' peels: one wrong
    round (one partition's round count off by one, on the first call of
    the main pass only) must fail ``mt_peel``; the unpatched peels pass."""
    from repro_torch.kernels import ops as kops

    mt = dict(smoke.MT, seeds=1, P=4,
              graphs={kind: dict(n_u=40, n_v=20, m=160, alpha=0.6)})
    hs, counts, _, _ = smoke.mt_peel(mt, "cpu")
    assert set(hs) == {f"{kind}0"} and not any(counts.values())
    name = f"fd_round_{kind}"
    real, calls = getattr(kops, name), []

    def wrong_once(*state):
        out = real(*state)
        if not calls:
            out[4][0].add_(1)                  # rounds of partition 0
        calls.append(1)
        return out

    monkeypatch.setattr(kops, name, wrong_once)
    with pytest.raises(AssertionError, match="differs from the plain"):
        smoke.mt_peel(mt, "cpu")
