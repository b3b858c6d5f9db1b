"""End-to-end: the port's csr peel on the CPU against the JAX package.

* all 72 csr cells of ``tests/goldens/peel_goldens.json`` (host, device
  and vmapped FD drivers; device/vmapped also with the fused round),
  field for field;
* the kernel route (``use_pallas``) on a subset of cells;
* live θ, partition and round/update parity with ``repro.core.peel`` and
  the BUP oracle ``repro.core.ref`` on numpy-seeded random graphs;
* the engine/driver validation texts, the API defaults and the device
  rule.  (The beindex and dense engines' cells are in
  ``tests/test_torch_engines.py``.)
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core import ref as core_ref
from repro.core.graph import BipartiteGraph as JGraph
from repro.core.peel import tip_decomposition as jtip
from repro.core.peel import wing_decomposition as jwing
from repro_torch.core import graph as tgraph
from repro_torch.core.peel import tip_decomposition, wing_decomposition

# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens", "peel_goldens.json")
GRAPHS = {
    "rb30": lambda: tgraph.random_bipartite(30, 24, 140, seed=0),
    "rb25": lambda: tgraph.random_bipartite(25, 20, 100, seed=1),
    "pl80": lambda: tgraph.powerlaw_bipartite(80, 40, 350, seed=2),
    "pl60": lambda: tgraph.powerlaw_bipartite(60, 50, 300, seed=3),
}
# a small graph drawn with numpy: (n_u, n_v, raw edge list)
_EDGES = (18, 14, np.stack([np.random.default_rng(3).integers(0, 18, 80),
                            np.random.default_rng(4).integers(0, 14, 80)], 1))
FIELDS = ("theta", "part", "ranges", "support_init", "rho_cd",
          "rho_fd_total", "rho_fd_max", "updates", "recounts",
          "p_effective")


def _snapshot(res) -> dict:
    s = res.stats
    return dict(
        theta=np.asarray(res.theta).tolist(),
        part=np.asarray(res.part).tolist(),
        ranges=np.asarray(res.ranges).tolist(),
        support_init=np.asarray(res.support_init).tolist(),
        rho_cd=s.rho_cd, rho_fd_total=s.rho_fd_total,
        rho_fd_max=s.rho_fd_max, updates=s.updates,
        recounts=s.recounts, p_effective=s.p_effective,
    )


@pytest.fixture(scope="module")
def goldens():
    with open(GOLDENS) as f:
        return json.load(f)


def _run_cell(g, key, fused=False, use_pallas=False):
    parts = key.split(".")
    kw = dict(P=int(parts[2][1:]), engine="csr", fd_driver=parts[-1],
              fused=fused, use_pallas=use_pallas, device="cpu")
    if parts[0] == "wing":
        return wing_decomposition(g, **kw)
    return tip_decomposition(g, side=parts[3], **kw)


def _cells(goldens, kind, gname):
    return sorted(k for k in goldens if k.startswith(f"{kind}.{gname}.")
                  and "csr" in k.split("."))


@pytest.mark.parametrize("kind", ["wing", "tip"])
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_csr_golden_cells(goldens, gname, kind):
    g = GRAPHS[gname]()
    cells = _cells(goldens, kind, gname)
    assert len(cells) == (6 if kind == "wing" else 12)
    for key in cells:
        fuse = (False, True) if key.split(".")[-1] != "host" else (False,)
        for fused in fuse:
            got = _snapshot(_run_cell(g, key, fused=fused))
            for f in FIELDS:
                assert got[f] == goldens[key][f], (key, fused, f)


@pytest.mark.parametrize("kind", ["wing", "tip"])
@pytest.mark.parametrize("gname", ["pl80", "rb25"])
def test_kernel_route_golden_cells(goldens, gname, kind):
    """``use_pallas``: CD through support_update / wedge_count (and the
    unfused vmapped wing FD through support_update), alone and with the
    fused rounds."""
    g = GRAPHS[gname]()
    for key in _cells(goldens, kind, gname):
        for fused in ((False, True) if key.split(".")[-1] != "host"
                      else (False,)):
            got = _snapshot(_run_cell(g, key, fused=fused, use_pallas=True))
            for f in FIELDS:
                assert got[f] == goldens[key][f], (key, fused, f)


@pytest.mark.parametrize("seed,P", [(11, 2), (205, 3), (4096, 5)])
def test_live_parity_with_reference_and_oracle(seed, P):
    """Graph edges drawn with numpy from the seed, fed to both packages."""
    rng = np.random.default_rng(seed)
    raw = np.stack([rng.integers(0, 18, 70), rng.integers(0, 14, 70)], 1)
    jg = JGraph.from_edges(18, 14, raw)
    tg = tgraph.BipartiteGraph.from_edges(18, 14, raw)
    np.testing.assert_array_equal(tg.edges, jg.edges)
    want = jwing(jg, P=P, engine="csr")
    np.testing.assert_array_equal(want.theta, core_ref.bup_wing_ref(jg))
    for fd in ("device", "vmapped", "host"):
        for fused in ((False, True) if fd != "host" else (False,)):
            got = wing_decomposition(tg, P=P, engine="csr", fd_driver=fd,
                                     fused=fused, device="cpu")
            assert _snapshot(got) == _snapshot(want), (fd, fused)
    for side in ("u", "v"):
        want = jtip(jg, side=side, P=P, engine="csr")
        np.testing.assert_array_equal(want.theta,
                                      core_ref.bup_tip_ref(jg, side))
        for fd in ("device", "vmapped", "host"):
            for fused in ((False, True) if fd != "host" else (False,)):
                got = tip_decomposition(tg, side=side, P=P, engine="csr",
                                        fd_driver=fd, fused=fused,
                                        device="cpu")
                assert _snapshot(got) == _snapshot(want), (side, fd, fused)


def test_validation_matches_reference(monkeypatch):
    """Each call the JAX package refuses, the port refuses with the same
    exception type: the engine/driver matrix, the tip/beindex refusal
    and the dense engine's memory guard."""
    g = tgraph.random_bipartite(10, 8, 24, seed=0)
    jg = JGraph.from_edges(g.n_u, g.n_v, g.edges)
    cases = [
        ("wing", dict(engine="csr", fd_driver="host", fused=True),
         ValueError),
        ("tip", dict(engine="csr", fd_driver="host", fused=True),
         ValueError),
        ("wing", dict(fused=True), ValueError),        # fused is csr only
        ("tip", dict(use_pallas=True), ValueError),    # ... so is use_pallas
        ("tip", dict(engine="beindex"), ValueError),
        ("wing", dict(engine="nope"), ValueError),
        ("wing", dict(fd_driver="nope"), ValueError),
    ]
    for kind, kw, exc in cases:
        for fn, extra in (((jwing, jtip), {}),
                          ((wing_decomposition, tip_decomposition),
                           dict(device="cpu"))):
            call = fn[0] if kind == "wing" else fn[1]
            with pytest.raises(exc):
                call(jg if not extra else g, **kw, **extra)
    monkeypatch.setenv("REPRO_DENSE_MAX_ELEMS", str(g.n_u * g.n_v - 1))
    for kind in ("wing", "tip"):
        for call, gg, extra in (
                ((jwing if kind == "wing" else jtip), jg, {}),
                ((wing_decomposition if kind == "wing"
                  else tip_decomposition), g, dict(device="cpu"))):
            with pytest.raises(MemoryError, match="use engine='csr'"):
                call(gg, engine="dense", **extra)


def test_api_defaults_match_reference():
    """The public entry points default as the JAX package's: dense for
    tip, beindex for wing, csr for ``build_peel_spec``; every other
    shared keyword too.  The port adds only ``device``."""
    import inspect

    from repro.core import peel as jpeel
    from repro_torch.core import peel as tpeel

    for name in ("tip_decomposition", "wing_decomposition",
                 "build_peel_spec", "wing_decomposition_bepc"):
        want = inspect.signature(getattr(jpeel, name)).parameters
        got = inspect.signature(getattr(tpeel, name)).parameters
        assert list(got) == [*want, "device"], name
        for key, p in want.items():
            assert got[key].default == p.default, (name, key)
        assert got["device"].default == "cuda", name
    assert inspect.signature(tpeel.tip_decomposition).parameters[
        "engine"].default == "dense"
    assert inspect.signature(tpeel.wing_decomposition).parameters[
        "engine"].default == "beindex"


def test_cuda_is_the_default_and_never_falls_back():
    g = tgraph.random_bipartite(10, 8, 24, seed=0)
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card refusal is not testable")
    with pytest.raises(RuntimeError, match="cuda"):
        tip_decomposition(g)
    with pytest.raises(RuntimeError, match="cuda"):
        wing_decomposition(g)


@pytest.mark.parametrize("kind", ["wing", "tip"])
def test_run_fd_subset_and_fixed_target_match_reference(kind):
    """``cd_loop`` with ``FixedTarget`` and ``run_fd(only=...,
    per_partition=...)`` — the entry points a partial re-peel drives —
    give the JAX package's partition, θ of the chosen partitions and
    per-partition counts."""
    from repro.core import peel as jpeel
    from repro.core import peelspec as jspec
    from repro_torch.core import peel as tpeel
    from repro_torch.core import peelspec as tspec

    jg = JGraph.from_edges(*_EDGES)
    tg = tgraph.BipartiteGraph.from_edges(*_EDGES)
    out = {}
    for name, pkg, spec_mod, g, extra in (
            ("jax", jpeel, jspec, jg, {}),
            ("torch", tpeel, tspec, tg, dict(device="cpu"))):
        stats = spec_mod.PeelStats()
        spec = pkg.build_peel_spec(g, kind, stats, engine="csr", **extra)
        target = spec_mod.FixedTarget(float(spec.est(spec.sup0).sum()), 4)
        part, sup_init, ranges, n = spec_mod.cd_loop(spec, 4, stats, target)
        theta = np.zeros(spec.n, dtype=np.int64)
        per = {}
        spec_mod.run_fd(spec, part, sup_init, theta, n, stats,
                        only=np.arange(n)[::2], per_partition=per)
        out[name] = (part.tolist(), ranges.tolist(), theta.tolist(), per,
                     stats.as_dict())
    assert out["torch"] == out["jax"]
    with pytest.raises(ValueError, match="only="):
        tspec.run_fd(spec, part, sup_init, theta, n, tspec.PeelStats(),
                     fd_driver="vmapped", only=np.arange(1))


def test_stats_and_result_records():
    from repro_torch.core.peelspec import PeelStats

    g = tgraph.BipartiteGraph.from_edges(*_EDGES)
    res = wing_decomposition(g, P=3, device="cpu")
    row = res.stats.as_dict()
    assert row["rho"] == res.stats.rho_cd
    assert PeelStats.from_dict(row) == res.stats
    prov = res.provenance()
    assert set(prov) == {"stats", "part", "ranges", "support_init"}
    np.testing.assert_array_equal(prov["part"], res.part)
