"""The port's observability layer (``src/repro_torch/obs``) against the
JAX package's ``repro.obs``, on the CPU.

* **Units** — the tracer, the disabled layer, ``REPRO_OBS_RING_CAP``,
  the metrics snapshot, ``percentiles`` and the timeline round trip,
  each held to the reference's output for the same calls.
* **Exact match** — with the layer on, span counts equal ``PeelStats``
  (``cd.round`` == ``rho_cd``, ``fd.round`` == ``rho_fd_total``) for
  every engine, FD driver and fused combination of ``tests/test_obs.py``,
  and the port's per-round curves (CD rows; per FD launch its mode,
  partitions, rounds, died / frontier / k rows and updates) equal the
  JAX package's timeline for the same run.  The port groups partitions
  into launches as the reference does — one launch a partition for the
  device, fused-device and host drivers (in LPT order), one launch for
  the whole phase for vmapped — so the launch lists compare one to one.
  A vmapped ring keeps a row for every iteration of the batched loop, so
  a partition that drained early holds (0, 0, the k sentinel) in the
  rows after its last round, in both packages.
* **Ring truncation** — ``REPRO_OBS_RING_CAP=2`` on cascades longer
  than the ring: the first row and the last round survive, round totals
  stay exact, and the truncated timeline equals the reference's.
* **Off contract** — with the layer off, every ``*_rings`` function is
  patched to raise, and θ, ``PeelStats`` and the kernels' launch counts
  equal those of a run with the layer on.
* **CLI** — ``repro_torch.launch.peel --trace`` writes a trace with the
  same event count per category as ``repro.launch.peel --trace``.
"""
import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.graph import random_bipartite as jrandom_bipartite
from repro.core.peel import tip_decomposition as jtip
from repro.core.peel import wing_decomposition as jwing
from repro.launch import peel as jpeel_cli
from repro_torch import obs
from repro_torch.core import peel as tpeel
from repro_torch.core import peelspec as tspec
from repro_torch.core.graph import random_bipartite
from repro_torch.core.peel import tip_decomposition, wing_decomposition
from repro_torch.kernels import ops
from repro_torch.launch import peel as tpeel_cli
from test_obs import TIP_COMBOS, WING_COMBOS

torch.set_num_threads(1)

# (kind, engine, fd_driver, fused, use_pallas): the reference's combos
# plus the drivers it leaves out — fused vmapped, the csr host driver,
# the dense wing engine and the unfused vmapped wing FD through
# support_update
CURVE_COMBOS = (
    [("wing", e, d, f, False) for e, d, f in WING_COMBOS]
    + [("tip", e, d, f, False) for e, d, f in TIP_COMBOS]
    + [("wing", "csr", "vmapped", True, False),
       ("wing", "csr", "host", False, False),
       ("wing", "dense", "host", False, False),
       ("wing", "csr", "vmapped", False, True),
       ("tip", "csr", "vmapped", True, False),
       ("tip", "csr", "host", False, False)])


def _ids(combos):
    return ["-".join(str(x) for x in c) for c in combos]


@pytest.fixture(autouse=True)
def layers_off():
    """Both packages' layers off before and after every test."""
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _run(pkg, kind, engine, fd_driver, fused, use_pallas=False):
    """One decomposition of random_bipartite(30, 24, 140, seed=1), P=4,
    through the port (``pkg="torch"``, on the CPU) or the reference."""
    kw = dict(P=4, engine=engine, fd_driver=fd_driver, fused=fused,
              use_pallas=use_pallas)
    if pkg == "torch":
        g = random_bipartite(30, 24, 140, seed=1)
        kw["device"] = "cpu"
        tip, wing = tip_decomposition, wing_decomposition
    else:
        g = jrandom_bipartite(30, 24, 140, seed=1)
        tip, wing = jtip, jwing
    if kind == "wing":
        return wing(g, **kw)
    return tip(g, side="u", **kw)


def _events(tracer):
    """Trace events without their timestamps and durations."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in tracer.events]


def _timeline_equal(got, want):
    assert set(got.cd) == set(want.cd)
    for key in want.cd:
        np.testing.assert_array_equal(got.cd[key], want.cd[key],
                                      err_msg=f"cd.{key}")
    assert len(got.fd) == len(want.fd)
    for j, (a, b) in enumerate(zip(got.fd, want.fd)):
        for key in ("mode", "parts", "rounds", "truncated"):
            assert a[key] == b[key], (j, key, a[key], b[key])
        for key in ("died", "frontier", "k"):
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"fd[{j}].{key}")
        if b["updates"] is None:
            assert a["updates"] is None
        else:
            np.testing.assert_array_equal(a["updates"], b["updates"],
                                          err_msg=f"fd[{j}].updates")


# =====================================================================
# units
# =====================================================================
def test_imports_with_jax_blocked():
    """``repro_torch.obs`` and ``repro_torch.streaming`` (and the stream
    CLI) import in a process where ``jax`` and ``repro`` cannot."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.obs, repro_torch.streaming, "
            "repro_torch.hierarchy.repair, repro_torch.launch.stream; "
            "print('ok')")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr



def _trace_calls(pkg):
    with pkg.span("outer", cat="peel", kind="wing"):
        with pkg.span("inner", cat="cd") as sp:
            sp.update(died=3, frontier=7)
        pkg.instant("tick", cat="fd.round", part=0)
        pkg.counter("curve", {"frontier": np.int64(7)})


def test_tracer_matches_reference(tmp_path):
    tracer = obs.enable()
    jtracer = jobs.enable()
    _trace_calls(obs)
    _trace_calls(jobs)
    assert _events(tracer) == _events(jtracer)
    for cat, ph in (("peel", None), ("cd", None), ("fd.round", "i"),
                    (None, "C")):
        assert tracer.count(cat, ph=ph) == jtracer.count(cat, ph=ph) == 1
    assert tracer.sum_arg("died", cat="cd") == 3
    (inner,) = tracer.spans("cd")
    (outer,) = tracer.spans("peel")
    assert inner["dur"] >= 0
    assert outer["ts"] <= inner["ts"]
    assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]
    path = str(tmp_path / "trace.json")
    tracer.save(path)
    with open(path) as f:
        chrome = json.load(f)
    assert set(chrome) == set(jtracer.to_chrome()) == {
        "traceEvents", "displayTimeUnit"}
    assert [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in chrome["traceEvents"]] == _events(jtracer)
    # the port's switch is its own
    obs.disable()
    assert jobs.enabled() and not obs.enabled()


def test_disabled_layer_is_inert():
    assert not obs.enabled()
    assert obs.get_tracer() is None
    with obs.span("ghost", cat="peel") as sp:
        assert sp is None
    assert obs.span("a") is obs.span("b")        # the shared null span
    obs.instant("ghost")
    obs.counter("ghost", {"x": 1})
    with obs.maybe_collect() as col:
        assert col is None
        assert obs.fd_ring_cap() == 0
    jobs.enable()                                # the reference's switch
    assert not obs.enabled() and obs.fd_ring_cap() == 0


def test_ring_cap_env(monkeypatch):
    obs.enable()
    jobs.enable()
    with obs.maybe_collect(), jobs.maybe_collect():
        for value in (None, "17", "bogus", "0"):
            if value is None:
                monkeypatch.delenv("REPRO_OBS_RING_CAP", raising=False)
            else:
                monkeypatch.setenv("REPRO_OBS_RING_CAP", value)
            assert obs.fd_ring_cap() == jobs.fd_ring_cap(), value
        monkeypatch.delenv("REPRO_OBS_RING_CAP")
        assert obs.fd_ring_cap() == obs.RING_CAP_DEFAULT == 1024
    assert obs.fd_ring_cap() == 0                # no live collector


def _metric_calls(reg):
    reg.inc("ops")
    reg.inc("ops", 4)
    reg.set_gauge("depth", 3)
    reg.set_gauge("depth", 9)
    for ms in (0.5, 1.0, 2.0, 4.0, 400.0, 0.0007, 9e4):
        reg.observe("lat", ms)
    reg.histogram("empty")
    reg.histogram("narrow", buckets=(1.0, 2.0)).record(1.5)


def test_metrics_snapshot_equals_reference(tmp_path):
    reg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    _metric_calls(reg)
    _metric_calls(jreg)
    snap = reg.snapshot()
    assert snap == jreg.snapshot()
    assert snap["ops"] == {"type": "counter", "value": 5}
    lat = snap["lat"]
    assert lat["min_ms"] <= lat["p50_ms"] <= lat["p99_ms"] <= lat["max_ms"]
    path = str(tmp_path / "metrics.json")
    reg.save(path)
    with open(path) as f:
        assert json.load(f) == snap
    with pytest.raises(TypeError):
        reg.observe("ops", 1.0)          # name already bound to a counter


def test_percentiles_equal_reference():
    rng = np.random.default_rng(0)
    for samples, ps in ((list(range(101)), (50.0, 99.0)), ([], (50.0, 99.0)),
                        ([7.0], (50.0, 90.0, 99.0)),
                        (rng.exponential(3.0, 257).tolist(),
                         (1.0, 50.0, 99.9))):
        assert obs.percentiles(samples, ps) == \
            jobs.percentiles(samples, ps)
    assert obs.percentiles(range(101)) == {"p50": 50.0, "p99": 99.0}


def _collect(pkg):
    col = pkg.TimelineCollector()
    col.record_cd_round(0, died=5, frontier=20, hi=3, updates=12,
                        recounts=2)
    col.record_cd_round(1, died=20, frontier=0, hi=9, updates=7,
                        recounts=0)
    col.record_fd_host(0, [dict(died=2, frontier=3, k=1),
                           dict(died=3, frontier=0, k=2)], updates=[4, 1])
    col.record_fd_rings("device", parts=[1], rounds=[2],
                        rings=(np.array([4, 1, 0]), np.array([6, 0, 0]),
                               np.array([1, 2, 0]), np.array([8, 3, 0])),
                        cap=3)
    col.record_fd_rings("fused", parts=[2, 3], rounds=[3, 1],
                        rings=(np.array([[1, 2], [1, 0], [2, 0]]),
                               np.array([[3, 0], [2, 0], [0, 0]]),
                               np.array([[1, 4], [2, 9], [3, 9]]),
                               np.array([[5, 2], [6, 2], [9, 2]])),
                        cap=3, cumulative_updates=True)
    col.record_fd_rings("vmapped", parts=[4], rounds=[5],
                        rings=(np.array([[1], [1]]), np.array([[9], [0]]),
                               np.array([[1], [5]]), np.array([2, 2])),
                        cap=2)
    col.record_fd_counts("counts", parts=[0, 1, 2], rounds=[3, 0, 4])
    return col.build()


def test_timeline_roundtrip_equals_reference():
    tl, jtl = _collect(obs), _collect(jobs)
    d = json.loads(json.dumps(tl.as_dict()))
    assert d == json.loads(json.dumps(jtl.as_dict()))
    assert tl.summary() == jtl.summary()
    for fn in ("fd_rounds_total", "fd_rounds_max", "updates_total",
               "truncated"):
        assert getattr(tl, fn)() == getattr(jtl, fn)(), fn
    assert tl.truncated() and tl.fd_rounds_total() == 2 + 2 + 4 + 5 + 7
    assert tl.fd[2]["updates"].tolist() == [7, 1, 3]   # cumulative → deltas
    back = obs.PeelTimeline.from_dict(d)
    assert back.summary() == tl.summary()
    assert back.as_dict() == d
    # the port's events equal the reference's for the same timeline
    tracer, jtracer = obs.enable(), jobs.enable()
    tl.emit_trace_events(tracer)
    jtl.emit_trace_events(jtracer)
    assert _events(tracer) == _events(jtracer)


# =====================================================================
# exact match: span counts == PeelStats; curves == the reference's
# =====================================================================
@pytest.mark.parametrize("kind,engine,fd_driver,fused",
                         [("wing", *c) for c in WING_COMBOS]
                         + [("tip", *c) for c in TIP_COMBOS],
                         ids=_ids([("wing", *c) for c in WING_COMBOS]
                                  + [("tip", *c) for c in TIP_COMBOS]))
def test_trace_counts_match_stats(kind, engine, fd_driver, fused):
    base = _run("torch", kind, engine, fd_driver, fused)
    assert base.timeline is None
    t = obs.enable()
    res = _run("torch", kind, engine, fd_driver, fused)
    obs.disable()
    np.testing.assert_array_equal(res.theta, base.theta)
    st = res.stats
    assert st.as_dict() == base.stats.as_dict()
    assert res.timeline.cd_rounds == st.rho_cd
    assert res.timeline.fd_rounds_total() == st.rho_fd_total
    assert res.timeline.fd_rounds_max() == st.rho_fd_max
    assert t.count("cd.round", ph="X") == st.rho_cd
    assert t.count("fd.round", ph="i") == st.rho_fd_total
    assert t.count("peel.cd", ph="C") == st.rho_cd
    assert t.count("peel", ph="X") == 1
    assert t.count("cd", ph="X") == 1
    assert t.count("fd", ph="X") == 1
    n_launch = 1 if fd_driver == "vmapped" else st.p_effective
    assert t.count("fd.launch", ph="X") == n_launch
    assert res.provenance()["timeline"]["cd_rounds"] == st.rho_cd


@pytest.mark.parametrize("kind,engine,fd_driver,fused,use_pallas",
                         CURVE_COMBOS, ids=_ids(CURVE_COMBOS))
def test_round_curves_equal_reference(kind, engine, fd_driver, fused,
                                      use_pallas):
    obs.enable()
    got = _run("torch", kind, engine, fd_driver, fused, use_pallas)
    jobs.enable()
    want = _run("jax", kind, engine, fd_driver, fused, use_pallas)
    np.testing.assert_array_equal(got.theta, want.theta)
    assert got.stats.as_dict() == want.stats.as_dict()
    _timeline_equal(got.timeline, want.timeline)
    assert got.timeline.summary() == want.timeline.summary()


# the FD drivers whose rings can overflow: (kind, fd_driver, fused)
RING_DRIVERS = [("wing", "device", False), ("wing", "vmapped", False),
                ("wing", "device", True), ("wing", "vmapped", True),
                ("tip", "device", False), ("tip", "vmapped", True)]


@pytest.mark.parametrize("kind,fd_driver,fused", RING_DRIVERS,
                         ids=_ids(RING_DRIVERS))
def test_ring_truncation(monkeypatch, kind, fd_driver, fused):
    obs.enable()
    full = _run("torch", kind, "csr", fd_driver, fused).timeline
    monkeypatch.setenv("REPRO_OBS_RING_CAP", "2")
    res = _run("torch", kind, "csr", fd_driver, fused)
    cut = res.timeline
    jobs.enable()
    want = _run("jax", kind, "csr", fd_driver, fused).timeline
    _timeline_equal(cut, want)
    assert cut.truncated()
    assert cut.fd_rounds_total() == res.stats.rho_fd_total
    assert cut.fd_rounds_max() == res.stats.rho_fd_max
    for a, b in zip(cut.fd, full.fd):
        last = max(b["rounds"]) - 1
        assert a["truncated"] == (last + 1 > 2)
        for key in ("died", "frontier", "k"):
            np.testing.assert_array_equal(a[key][0], b[key][0])
            if last >= 1:
                # row cap-1 holds the launch's last iteration
                np.testing.assert_array_equal(a[key][1], b[key][last])


# =====================================================================
# the off contract
# =====================================================================
def _ring_names(mod):
    return [n for n in vars(mod) if n.endswith("_rings")]


def test_ring_functions_exist():
    assert set(_ring_names(tspec)) >= {
        "_fd_while_vmapped_rings", "_fd_while_device_rings",
        "_fd_while_fused_rings", "_new_rings", "_host_rings"}
    assert "_drain_rings" in _ring_names(tpeel)


@pytest.mark.parametrize("kind,engine,fd_driver,fused,use_pallas",
                         CURVE_COMBOS, ids=_ids(CURVE_COMBOS))
def test_off_contract(monkeypatch, kind, engine, fd_driver, fused,
                      use_pallas):
    def run():
        ops.reset_launch_counts()
        res = _run("torch", kind, engine, fd_driver, fused, use_pallas)
        return res, ops.launch_counts()

    obs.enable()
    on, on_launches = run()
    obs.disable()
    assert on.timeline is not None

    def refuse(*a, **k):
        raise AssertionError("ring code ran with the obs layer off")

    for mod in (tspec, tpeel):
        for name in _ring_names(mod):
            monkeypatch.setattr(mod, name, refuse)
    off, off_launches = run()
    assert off.timeline is None
    np.testing.assert_array_equal(off.theta, on.theta)
    assert off.stats.as_dict() == on.stats.as_dict()
    assert off_launches == on_launches
    assert "timeline" not in off.provenance()


# =====================================================================
# the CLI: --trace against the reference CLI's trace
# =====================================================================
CLI_CASES = [
    ["--kind", "tip", "--n-u", "60", "--n-v", "40", "--m", "260",
     "--parts", "4"],
    ["--kind", "wing", "--engine", "csr", "--fd-driver", "vmapped",
     "--n-u", "40", "--n-v", "30", "--m", "160", "--parts", "4",
     "--emit-hierarchy", "{tmp}/h.npz"],
]


@pytest.mark.parametrize("argv", CLI_CASES, ids=["tip", "wing-hierarchy"])
def test_cli_trace_matches_reference(argv, tmp_path, monkeypatch, capsys):
    def cats(path):
        with open(path) as f:
            return collections.Counter(
                e["cat"] for e in json.load(f)["traceEvents"])

    def lines(text):
        return [ln.split(" -> ")[0] for ln in text.splitlines()
                if ln.startswith(("[peel] timeline:", "[peel] theta:",
                                  "[peel] trace:"))]

    argv = [a.format(tmp=tmp_path) for a in argv]
    tpath, jpath = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tpeel_cli.main([*argv, "--trace", tpath, "--device", "cpu"])
    assert not obs.enabled()             # off again after the run
    got = lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv",
                        ["repro.launch.peel", *argv, "--trace", jpath])
    with pytest.raises(SystemExit) as ex:
        jpeel_cli.main()
    assert ex.value.code == 0
    want = lines(capsys.readouterr().out)
    assert got == want and len(got) == 3
    assert cats(tpath) == cats(jpath)
    assert cats(tpath)["fd.round"] > 0
