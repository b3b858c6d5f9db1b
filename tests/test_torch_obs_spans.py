"""The port's program spans and counters (``repro_torch.obs.span`` with
its profiler and ``seconds`` sinks, ``obs.counts()``, ``gc_pauses``), on
the CPU, for four of the peel's paths: tip csr with the fused device FD,
tip csr with the fused vmapped FD, wing beindex, wing csr with the
unfused device FD.

* θ and ``PeelStats`` equal the JAX package's, whichever sinks are on.
* The peel CLI's ``seconds`` has every step's key, each ≥ 0, and the
  spec's steps fit in the peel's time outside its two phases.
* Under ``torch.profiler`` with the layer off, every span is a
  ``user_annotation``, a span yields ``None`` and no Tracer exists; with
  the layer on, the new spans write no Tracer event, and a Tracer span
  starts where the profiler's does (its export's ``ts`` plus
  ``baseTimeNanoseconds``).
* ``fd.host_syncs`` equals the FD drivers' reads, counted from the
  rounds they queued: one flag read a chunk of ``FD_CHUNK`` rounds and
  one more at a loop's end, then the rounds, update count and θ read
  back after each dispatch; one read a decomposition for the beindex
  engine's one ``fd_wing_beindex`` launch.
"""
import dataclasses
import gc
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro import obs as jobs
from repro.core.graph import powerlaw_bipartite as jpowerlaw_bipartite
from repro.core.peel import tip_decomposition as jtip
from repro.core.peel import wing_decomposition as jwing
from repro_torch import obs
from repro_torch.core import peel as tpeel
from repro_torch.core import peelspec as tspec
from repro_torch.core.graph import BipartiteGraph, powerlaw_bipartite
from repro_torch.kernels import ops
from repro_torch.launch import peel as tpeel_cli

torch.set_num_threads(1)

# (kind, engine, fd_driver, fused): the benchmark's two paths (tip csr
# fused device, wing beindex) and a vmapped and an unfused csr driver
COMBOS = [("tip", "csr", "device", True), ("tip", "csr", "vmapped", True),
          ("wing", "beindex", "device", False),
          ("wing", "csr", "device", False)]
IDS = ["-".join(str(x) for x in c) for c in COMBOS]
GRAPH = (50, 40, 420, 3)        # n_u, n_v, m, seed
P = 3
# spans of the peel CLI that every path opens
COMMON = {"run", "peel.summary", "spec.supports", "spec.upload", "fd.pack",
          "cd", "fd"}
NEW_SPANS = {"spec.wedges", "spec.supports", "spec.beindex", "spec.upload",
             "fd.pack", "graph.from_edges", "peel.summary", "run"}


@pytest.fixture(autouse=True)
def layers_off():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _graph():
    return powerlaw_bipartite(*GRAPH[:3], seed=GRAPH[3])


def _decompose(combo, g=None):
    kind, engine, fd_driver, fused = combo
    kw = dict(P=P, engine=engine, fd_driver=fd_driver, fused=fused,
              device="cpu")
    g = _graph() if g is None else g
    if kind == "tip":
        return tpeel.tip_decomposition(g, side="u", **kw)
    return tpeel.wing_decomposition(g, **kw)


def _cli(combo, g=None):
    kind, engine, fd_driver, fused = combo
    args = tpeel_cli.build_parser().parse_args(
        ["--kind", kind, "--engine", engine, "--fd-driver", fd_driver,
         "--fused-fd" if fused else "--no-fused-fd", "--parts", str(P),
         "--device", "cpu"])
    return tpeel_cli.run(args, _graph() if g is None else g)


def _spans_of(combo):
    kind, engine = combo[:2]
    return COMMON | {"spec.beindex" if engine == "beindex"
                     else "spec.wedges"}


def _annotations(prof, tmp_path):
    path = str(tmp_path / "prof.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    return trace, [e for e in trace["traceEvents"]
                   if e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_theta_and_stats_unchanged(combo, tmp_path):
    kind, engine, fd_driver, fused = combo
    jg = jpowerlaw_bipartite(*GRAPH[:3], seed=GRAPH[3])
    jkw = dict(P=P, engine=engine, fd_driver=fd_driver, fused=fused)
    want = (jtip(jg, side="u", **jkw) if kind == "tip"
            else jwing(jg, **jkw))
    plain = _decompose(combo)
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _decompose(combo)
    obs.enable()
    traced = _decompose(combo)
    obs.disable()
    for res in (plain, profiled, traced):
        np.testing.assert_array_equal(res.theta, np.asarray(want.theta))
        assert res.stats.as_dict() == want.stats.as_dict()


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_seconds_keys(combo):
    g = _graph()
    sec = _cli(combo, g)["seconds"]
    keys = set(tpeel.SPEC_SECONDS) | {"cd", "fd", "peel", "peel.summary",
                                      "graph", "run", "gc"}
    assert keys <= set(sec)
    assert all(sec[k] >= 0 for k in keys)
    spec = sum(sec[k] for k in tpeel.SPEC_SECONDS if k.startswith("spec."))
    assert spec <= sec["peel"] - sec["cd"] - sec["fd"]
    assert sec["fd.pack"] <= sec["fd"]
    assert sec["peel"] + sec["peel.summary"] <= sec["run"]
    assert sec["graph"] == g.build_seconds() > 0
    for name in _spans_of(combo) - {"run", "peel.summary", "cd", "fd"}:
        assert sec[name] > 0, name
    res = _decompose(combo, g)
    assert set(tpeel.SPEC_SECONDS) | {"cd", "fd"} == set(res.seconds)


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_profiler_names_spans_with_layer_off(combo, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        g = BipartiteGraph.from_edges(GRAPH[0], GRAPH[1],
                                      _graph().edges)
        _cli(combo, g)
        with obs.span("probe", cat="peel") as sp:
            assert sp is None
        with obs.span("probe.timed", seconds={}, event=False) as sp:
            assert sp is None
    assert obs.get_tracer() is None
    _, ann = _annotations(prof, tmp_path)
    names = {e["name"] for e in ann}
    assert _spans_of(combo) | {"graph.from_edges", "probe",
                               "probe.timed"} <= names
    assert "peel.decompose" in names


@pytest.mark.parametrize("combo", COMBOS, ids=IDS)
def test_fd_host_syncs(combo, monkeypatch):
    kind, engine, fd_driver, fused = combo
    rounds = [0]
    if fused or engine == "beindex":
        name = ("fd_wing_beindex" if engine == "beindex" else
                "fd_round_tip" if kind == "tip" else "fd_round_wing")
        orig = getattr(ops, name)

        def counted(*a, **k):
            rounds[0] += 1
            return orig(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    else:
        orig = tspec._peel_round

        def counted(*a, **k):
            rounds[0] += 1
            return orig(*a, **k)
        monkeypatch.setattr(tspec, "_peel_round", counted)
    before = obs.counts()
    res = _decompose(combo)
    got = {k: v - before.get(k, 0) for k, v in obs.counts().items()}
    st = res.stats
    assert got["peel.decompositions"] == 1
    if engine == "beindex":
        # one fd_wing_beindex launch for every partition, then one read
        # of θ, the rounds and the update counts
        assert rounds[0] == 1 and st.rho_fd_total > 1
        want = 1
    else:
        chunks, rest = divmod(rounds[0], tspec.FD_CHUNK)
        assert rest == 0 and chunks >= (
            1 if fd_driver == "vmapped" else st.p_effective)
        if fd_driver == "vmapped":
            # one loop: its last flag read, then θ and the rounds
            want = chunks + 3
        else:
            # a loop a partition: its last flag read, then the rounds,
            # θ and (wing) the update count
            want = chunks + st.p_effective * (3 if kind == "tip" else 4)
    assert got["fd.host_syncs"] == want


def test_layer_off_makes_no_tracer_and_no_event():
    assert obs.span("a") is obs.span("b")        # the shared null span
    sec = {}
    with obs.span("timed", seconds=sec) as sp:
        assert sp is None
    assert sec["timed"] >= 0 and obs.get_tracer() is None
    tracer = obs.enable()
    _cli(COMBOS[0])
    names = {e["name"] for e in tracer.events}
    assert not names & NEW_SPANS
    assert {"peel.decompose", "cd", "fd"} <= names
    with obs.span("late", cat="peel", seconds=sec) as sp:
        sp.update(x=1)
    (ev,) = tracer.spans("peel")[-1:]
    assert ev["name"] == "late" and ev["args"] == {"x": 1}
    assert sec["late"] >= 0


def test_tracer_and_profiler_clocks_agree(tmp_path):
    tracer = obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.002)
        with obs.span("clock.probe", cat="peel"):
            time.sleep(0.005)
    trace, ann = _annotations(prof, tmp_path)
    (p_ev,) = [e for e in ann if e["name"] == "clock.probe"]
    (t_ev,) = [e for e in tracer.events if e["name"] == "clock.probe"]
    p_ts = float(p_ev["ts"]) + trace.get("baseTimeNanoseconds", 0) / 1e3
    assert abs(t_ev["ts"] - p_ts) < 2000.0
    # microseconds since the Unix epoch
    assert abs(t_ev["ts"] - time.time_ns() / 1e3) < 60e6


def test_gc_pauses_and_counts():
    sec = {}
    n_hooks = len(gc.callbacks)
    with obs.gc_pauses(sec):
        assert len(gc.callbacks) == n_hooks + 1
        gc.collect()
    assert len(gc.callbacks) == n_hooks
    after = sec["gc"]
    assert after > 0
    gc.collect()                     # outside the block: not counted
    assert sec["gc"] == after
    obs.reset_counts()
    obs.count("x")
    obs.count("x", 2)
    assert obs.counts() == {"x": 3}
    obs.reset_counts()
    assert obs.counts() == {}


def test_graph_seconds_travel_with_the_graph():
    g = _graph()
    h = BipartiteGraph(g.n_u, g.n_v, g.edges)
    assert g == h and g.build_seconds() > 0
    assert h.build_seconds() == 0.0 and g.transpose().build_seconds() == 0.0
    assert [f.name for f in dataclasses.fields(g)] == ["n_u", "n_v", "edges"]
