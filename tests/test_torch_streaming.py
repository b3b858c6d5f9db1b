"""The port's streaming updater (``src/repro_torch/streaming``,
``hierarchy/repair.py``, ``launch/stream.py``) on the CPU.

The contract is the reference's: after every micro-epoch the
incrementally maintained θ, partition, ⋈init, ``PeelStats`` row and
every packed-forest array equal a from-scratch re-peel and rebuild of
the materialized graph.  Checked here by

* replaying the three cases of ``tests/goldens/stream_goldens.json``
  (the JAX package's digests) bit for bit;
* the reference's differential sweep (``tests/test_streaming.py``),
  plus the kernel route (``use_pallas=True``) for one wing and one tip
  case, against the port's own from-scratch re-peel;
* a hypothesis property test over arbitrary insert/delete sequences,
  its strategies bound by keyword;
* the copies of ``events.py`` and ``delta.py`` held equal to the
  originals, and the units and CLI against ``repro.launch.stream``.
"""
import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.streaming as jstream
from repro.core.graph import random_bipartite as jrandom_bipartite
from repro.launch import stream as jstream_cli
from repro.streaming import delta as jdelta
from repro_torch import obs
from repro_torch.core import csr
from repro_torch.core.graph import powerlaw_bipartite, random_bipartite
from repro_torch.core.peel import (PeelStats, build_peel_spec,
                                   tip_decomposition, wing_decomposition)
from repro_torch.core.peelspec import cd_loop, run_fd
from repro_torch.hierarchy import build_hierarchy
from repro_torch.hierarchy.repair import dirty_subtrees
from repro_torch.launch import stream as stream_cli
from repro_torch.streaming import (EdgeEvent, StreamConfig, StreamState,
                                   apply_events, coalesce, load_trace,
                                   make_random_events, save_trace)
from repro_torch.streaming import delta as tdelta

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    path = os.path.join(HERE, "goldens", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_REC = _load("record_stream_goldens.py")
_TREC = _load("record_torch_stream.py")


def _scratch(g, cfg):
    """From-scratch reference of the port for the materialized graph."""
    kw = dict(P=cfg.P, engine=cfg.engine, fd_driver=cfg.fd_driver,
              use_pallas=cfg.use_pallas, device="cpu")
    if cfg.kind == "wing":
        res = wing_decomposition(g, **kw)
    else:
        res = tip_decomposition(g, side=cfg.side,
                                batch_recount=cfg.batch_recount, **kw)
    return res, build_hierarchy(g, res, kind=cfg.kind, side=cfg.side,
                                device="cpu")


def _assert_identical(state, msg):
    """The whole contract: θ / part / ⋈init / ranges / stats / forest."""
    ref, h_ref = _scratch(state.g, state.config)
    res = state.result
    for f in ("theta", "part", "support_init", "ranges"):
        assert np.array_equal(getattr(res, f), getattr(ref, f)), \
            f"{msg}: {f}"
    assert res.stats.as_dict() == ref.stats.as_dict(), f"{msg}: stats"
    h = state.hierarchy
    for f in _REC.FOREST_FIELDS:
        assert np.array_equal(getattr(h, f), getattr(h_ref, f)), \
            f"{msg}: forest.{f}"
    assert np.allclose(h.density, h_ref.density), f"{msg}: density"


# ------------------------------------------------------------ golden lock
@pytest.mark.parametrize("case", sorted(_REC.CASES))
def test_stream_goldens_replay(case):
    """The JAX package's recorded digests, epoch for epoch."""
    with open(_REC.GOLDEN_PATH) as f:
        want = json.load(f)["cases"][case]
    kind, engine, fd_driver, P, gspec, epochs, batch, seed = _REC.CASES[case]
    n_u, n_v, m, gseed = gspec
    state = StreamState.initial(
        powerlaw_bipartite(n_u, n_v, m, seed=gseed),
        StreamConfig(kind=kind, engine=engine, P=P, fd_driver=fd_driver),
        device="cpu")
    assert len(want) == epochs
    for e in range(epochs):
        rep = state.apply_epoch(make_random_events(state.g, batch,
                                                   seed=seed + e))
        got = _TREC.epoch_record(_REC, state, rep)
        assert got == want[e], f"{case} epoch {want[e]['epoch']}"


# ------------------------------------------------------- deterministic sweep
SWEEP = [
    ("wing", "csr", "device", "u", False),
    ("wing", "csr", "host", "u", False),
    ("wing", "csr", "vmapped", "u", False),
    ("wing", "dense", "host", "u", False),
    ("tip", "csr", "device", "u", False),
    ("tip", "csr", "device", "v", False),
    ("tip", "dense", "host", "u", False),
    # the kernel route: CD through support_update / wedge_count
    ("wing", "csr", "device", "u", True),
    ("tip", "csr", "device", "u", True),
]


@pytest.mark.parametrize("kind,engine,fd_driver,side,use_pallas", SWEEP,
                         ids=["-".join(map(str, c)) for c in SWEEP])
def test_differential_stream(kind, engine, fd_driver, side, use_pallas):
    g = random_bipartite(24, 18, 90, seed=11)
    cfg = StreamConfig(kind=kind, side=side, engine=engine, P=6,
                       fd_driver=fd_driver, use_pallas=use_pallas)
    state = StreamState.initial(g, cfg, device="cpu")
    _assert_identical(state, f"{kind}/{engine} epoch0")
    for e, (n_ev, p_del) in enumerate([(9, 0.3), (1, 0.0), (16, 0.7),
                                       (5, 0.5)]):
        events = make_random_events(state.g, n_ev, seed=50 + e,
                                    p_delete=p_del)
        state.apply_epoch(events)
        _assert_identical(state, f"{kind}/{engine} epoch{e + 1}")


def test_duplicate_and_self_cancelling_events():
    g = random_bipartite(20, 15, 70, seed=4)
    state = StreamState.initial(
        g, StreamConfig(kind="wing", engine="csr", P=4), device="cpu")
    u0, v0 = map(int, g.edges[0])
    events = [
        EdgeEvent("-", u0, v0), EdgeEvent("+", u0, v0),
        EdgeEvent("+", 19, 14), EdgeEvent("+", 19, 14),
        EdgeEvent("+", 0, 14), EdgeEvent("-", 0, 14),
    ]
    rep = state.apply_epoch(events)
    assert (rep.n_inserts, rep.n_deletes) in {(1, 0), (0, 0)}
    _assert_identical(state, "dup/cancel epoch")


def test_noop_epoch_serves_unchanged():
    g = random_bipartite(20, 15, 70, seed=4)
    state = StreamState.initial(
        g, StreamConfig(kind="wing", engine="csr", P=4), device="cpu")
    res0, h0 = state.result, state.hierarchy
    u0, v0 = map(int, g.edges[0])
    rep = state.apply_epoch([EdgeEvent("-", u0, v0),
                             EdgeEvent("+", u0, v0)])
    assert rep.noop and rep.partitions_dirty == 0
    assert state.result is res0 and state.hierarchy is h0
    assert state.metrics.snapshot()["stream.noop_epochs"]["value"] == 1


# ------------------------------------------------------------ hypothesis
_EXAMPLES = 1000 if os.environ.get("HYPOTHESIS_PROFILE") == "nightly" \
    else 8

# mixed micro-epoch sizes (1-7 events) over 1-2 epochs
_EVENT_EPOCHS = st.lists(
    st.lists(st.tuples(st.booleans(), st.integers(0, 11),
                       st.integers(0, 8)),
             min_size=1, max_size=7),
    min_size=1, max_size=2)


# strategies bound by keyword: hypothesis binds positional strategies to
# the rightmost parameters
@settings(max_examples=_EXAMPLES, deadline=None)
@given(epochs=_EVENT_EPOCHS,
       kind_engine=st.sampled_from([("wing", "csr"), ("wing", "dense"),
                                    ("tip", "csr"), ("tip", "dense")]))
def test_property_incremental_equals_scratch(epochs, kind_engine):
    kind, engine = kind_engine
    g = random_bipartite(12, 9, 30, seed=2)
    cfg = StreamConfig(kind=kind, engine=engine, P=4,
                       fd_driver="device" if engine == "csr" else "host")
    state = StreamState.initial(g, cfg, device="cpu")
    for i, evs in enumerate(epochs):
        state.apply_epoch([EdgeEvent("+" if ins else "-", u, v)
                           for ins, u, v in evs])
        _assert_identical(state, f"property {kind}/{engine} epoch{i}")


# ------------------------------------------------- the copies == originals
def test_events_and_delta_equal_reference(tmp_path):
    g = random_bipartite(16, 12, 60, seed=9)
    jg = jrandom_bipartite(16, 12, 60, seed=9)
    events = make_random_events(g, 24, seed=3, p_delete=0.5)
    jevents = jstream.make_random_events(jg, 24, seed=3, p_delete=0.5)
    assert [(e.op, e.u, e.v) for e in events] == \
        [(e.op, e.u, e.v) for e in jevents]
    ins, dels = coalesce(events, g)
    jins, jdels = jstream.coalesce(jevents, jg)
    assert np.array_equal(ins, jins) and np.array_equal(dels, jdels)
    g_new = apply_events(g, ins, dels)
    jg_new = jstream.apply_events(jg, jins, jdels)
    assert np.array_equal(g_new.edges, jg_new.edges)
    path = str(tmp_path / "trace.jsonl")
    save_trace(path, events)
    assert load_trace(path) == events
    assert [(e.op, e.u, e.v) for e in jstream.load_trace(path)] == \
        [(e.op, e.u, e.v) for e in events]
    for kind in ("wing", "tip"):
        got = tdelta.support_delta(g, ins, dels, kind)
        assert got == jdelta.support_delta(jg, jins, jdels, kind), kind
        oc, nc = tdelta.common_entities(g, g_new, kind)
        joc, jnc = jdelta.common_entities(jg, jg_new, kind)
        assert np.array_equal(oc, joc) and np.array_equal(nc, jnc)
    sup_old = csr.edge_butterflies0(csr.build_wedges(g)).astype(np.int64)
    dlt, _ = tdelta.support_delta(g, ins, dels, "wing")
    assert np.array_equal(tdelta.wing_sup0_new(g, sup_old, g_new, dlt),
                          jdelta.wing_sup0_new(jg, sup_old, jg_new, dlt))
    assert np.array_equal(tdelta.edge_codes(g), jdelta.edge_codes(jg))
    rng = np.random.default_rng(5)
    oc, nc = tdelta.common_entities(g, g_new, "wing")
    args = (rng.integers(0, 4, g.m), rng.integers(0, 5, g_new.m), oc, nc,
            rng.integers(0, 9, g.m), rng.integers(0, 9, g_new.m),
            rng.random(g.m) < 0.1, rng.random(g_new.m) < 0.1, 4, 5)
    assert np.array_equal(tdelta.dirty_partitions(*args),
                          jdelta.dirty_partitions(*args))


# ------------------------------------------------------------ delta layer
def test_coalesce_semantics():
    g = random_bipartite(10, 8, 25, seed=1)
    u0, v0 = map(int, g.edges[0])
    absent = next((u, v) for u in range(10) for v in range(8)
                  if not any((u, v) == (int(a), int(b))
                             for a, b in g.edges))
    ins, dels = coalesce([
        EdgeEvent("+", u0, v0),              # already present -> drop
        EdgeEvent("-", *absent),             # absent delete  -> drop
        EdgeEvent("+", *absent),             # last op wins   -> insert
        EdgeEvent("-", u0, v0),              # net delete
    ], g)
    assert [tuple(r) for r in ins] == [absent]
    assert [tuple(r) for r in dels] == [(u0, v0)]
    z_ins, z_dels = coalesce([], g)
    assert z_ins.shape == z_dels.shape == (0, 2)
    with pytest.raises(ValueError):
        coalesce([EdgeEvent("+", 10, 0)], g)
    with pytest.raises(ValueError):
        EdgeEvent("x", 0, 0)


def test_support_delta_matches_recount():
    g = random_bipartite(16, 12, 60, seed=9)
    ins, dels = coalesce(make_random_events(g, 12, seed=3, p_delete=0.5), g)
    g_new = apply_events(g, ins, dels)
    sup_old = csr.edge_butterflies0(csr.build_wedges(g)).astype(np.int64)
    dlt, touched = tdelta.support_delta(g, ins, dels, "wing")
    got = tdelta.wing_sup0_new(g, sup_old, g_new, dlt)
    want = csr.edge_butterflies0(csr.build_wedges(g_new)).astype(np.int64)
    assert np.array_equal(got, want)
    assert all(k in touched for k in dlt)
    sup_tip = csr.vertex_butterflies_csr(
        csr.build_wedges(g)).astype(np.int64)
    dlt_t, _ = tdelta.support_delta(g, ins, dels, "tip")
    for u, d in dlt_t.items():
        sup_tip[u] += d
    assert np.array_equal(sup_tip, csr.vertex_butterflies_csr(
        csr.build_wedges(g_new)).astype(np.int64))
    with pytest.raises(ValueError):
        tdelta.support_delta(g, ins, dels, "edge")


# ----------------------------------------------------------- config / run_fd
def test_stream_config_validation():
    with pytest.raises(ValueError):
        StreamConfig(engine="beindex")
    with pytest.raises(ValueError):
        StreamConfig(fd_driver="fused")
    with pytest.raises(ValueError):
        StreamConfig(engine="dense", fd_driver="vmapped")
    with pytest.raises(ValueError):
        StreamConfig(kind="wing", side="v")
    with pytest.raises(ValueError):
        StreamConfig(kind="edge")
    assert StreamConfig(fd_driver="vmapped").fd_driver == "vmapped"
    # no card here: the default device raises rather than falling back
    g = random_bipartite(8, 6, 16, seed=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            StreamState(g, StreamConfig())


def test_run_fd_only_validation():
    g = random_bipartite(16, 12, 60, seed=9)
    stats = PeelStats(engine="csr", fd_driver="vmapped")
    spec = build_peel_spec(g, "wing", stats, engine="csr", device="cpu")
    part, sup_init, ranges, p_eff = cd_loop(spec, 4, stats)
    theta = np.zeros(spec.n, dtype=np.int64)
    with pytest.raises(ValueError):
        run_fd(spec, part, sup_init, theta, p_eff, stats,
               fd_driver="vmapped", only=np.array([0]))
    with pytest.raises(ValueError):
        run_fd(spec, part, sup_init, theta, p_eff, stats,
               fd_driver="device", only=np.array([p_eff + 3]))
    # a subset runs alone and reports its per-partition counts
    pp = {}
    run_fd(spec, part, sup_init, theta, p_eff, PeelStats(),
           fd_driver="device", only=np.array([0]), per_partition=pp)
    assert list(pp) == [0]
    assert not theta[part != 0].any()


# ------------------------------------------------------------ obs coupling
def test_obs_off_on_theta_identity_and_spans():
    g = random_bipartite(20, 15, 70, seed=6)
    cfg = StreamConfig(kind="wing", engine="csr", P=4)
    ev = make_random_events(g, 8, seed=77)
    state_off = StreamState.initial(g, cfg, device="cpu")
    state_off.apply_epoch(list(ev))
    tracer = obs.enable()
    try:
        state_on = StreamState.initial(g, cfg, device="cpu")
        p0 = state_on.result.stats.p_effective
        rep = state_on.apply_epoch(list(ev))
    finally:
        obs.disable()
    assert np.array_equal(state_on.result.theta, state_off.result.theta)
    assert state_on.result.stats.as_dict() == \
        state_off.result.stats.as_dict()
    count = {n: sum(e["name"] == n for e in tracer.events)
             for n in ("stream.epoch", "stream.cd", "stream.fd",
                       "stream.repair", "hierarchy.repair",
                       "repair.partitions_dirty")}
    # two epochs (the initial one and one of events), one of each a run
    assert count == dict.fromkeys(count, 2), count
    dirty = [e["args"]["dirty"] for e in tracer.events
             if e["name"] == "repair.partitions_dirty"]
    assert dirty[-1] == rep.partitions_dirty
    # one fd.launch span a partition re-peeled: all of them at first
    assert tracer.count("fd.launch") == p0 + rep.partitions_dirty
    snap = state_on.metrics.snapshot()
    assert snap["stream.epochs"]["value"] == 2
    assert snap["stream.repair_ms"]["count"] == 2


# ------------------------------------------------------- serving-side bound
def test_dirty_subtrees_and_stale_bound():
    g = random_bipartite(24, 18, 90, seed=11)
    res = wing_decomposition(g, P=6, engine="csr", device="cpu")
    h = build_hierarchy(g, res, device="cpu")
    ids = np.arange(0, g.m, 7)
    nodes, slices = dirty_subtrees(h, ids)
    assert all(lo < hi for lo, hi in slices)
    assert all(hi <= lo2 for (_, hi), (lo2, _) in zip(slices, slices[1:]))
    covered = set()
    for lo, hi in slices:
        covered.update(range(lo, hi))
    pos = {int(e): i for i, e in enumerate(h.ent_order.tolist())}
    for e in ids.tolist():
        if int(h.theta[e]) > 0:
            assert pos[e] in covered
    n2, s2 = dirty_subtrees(h, np.zeros(0, dtype=np.int64))
    assert n2.size == 0 and s2 == []
    state = StreamState.initial(
        g, StreamConfig(kind="wing", engine="csr", P=6), device="cpu")
    rep = state.apply_epoch(make_random_events(g, 6, seed=8))
    assert not rep.noop
    assert 0 < rep.stale_nodes <= state.hierarchy.n_nodes + 64
    assert rep.stale_entities <= state.g.m + 64
    assert rep.epoch_ms >= rep.repair_ms >= 0.0


# ---------------------------------------------------------------- the CLI
_TIMES = re.compile(r"(repair|epoch)=[0-9.]+ms|avg epoch [0-9.]+ms")


def _stream_lines(text):
    return [_TIMES.sub("<t>", ln) for ln in text.splitlines()
            if ln.startswith("[stream")]


@pytest.mark.parametrize("flags", [
    ["--epochs", "2", "--batch", "6", "--n-u", "24", "--n-v", "18",
     "--m", "90", "--parts", "6"],
    ["--kind", "tip", "--events", "{trace}", "--batch", "5", "--n-u", "20",
     "--n-v", "15", "--m", "70", "--parts", "4"],
    ["--dryrun"],
], ids=["epochs", "events", "dryrun"])
def test_cli_matches_reference(flags, tmp_path, monkeypatch, capsys):
    trace = str(tmp_path / "ev.jsonl")
    save_trace(trace, make_random_events(random_bipartite(
        20, 15, 70, seed=0), 12, seed=4))
    flags = [f.format(trace=trace) for f in flags]
    assert stream_cli.main([*flags, "--device", "cpu"]) == 0
    got = _stream_lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["repro.launch.stream", *flags])
    with pytest.raises(SystemExit) as ex:
        jstream_cli.main()
    assert ex.value.code == 0
    want = _stream_lines(capsys.readouterr().out)
    assert got == want and len(got) >= 3
