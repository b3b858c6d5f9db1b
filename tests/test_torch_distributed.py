"""The port's distributed peel against the JAX package's.

The JAX package is the oracle, in this process only: its layouts are
numpy (held array-equal here at 1, 4, 8 and 512 shards), and its
distributed results on 8 forced host devices are the golden
``tests/goldens/torch_distributed.json`` (written by
``record_torch_distributed.py``).  The port's ranks run in child
processes that import ``torch`` and ``repro_torch`` only
(``tests/goldens/distributed_replay.py``): gloo on the CPU, a
``file://`` rendezvous, one spawn per world size for the whole file.
Every result is an integer, so every comparison is exact.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.core import distributed as jdist
from repro.core import graph as jgraph
from repro.core.beindex import build_beindex as jbuild_beindex
from repro.core.peel import wing_decomposition as jwing
from repro.launch import peel as jcli
from repro_torch.core import csr as tcsr
from repro_torch.core import distributed as tdist
from repro_torch.core import graph as tgraph
from repro_torch.core.beindex import build_beindex as tbuild_beindex
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import peel as tcli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
with open(os.path.join(GOLDENS, "torch_distributed.json")) as _f:
    GOLDEN = json.load(_f)
FIELDS = ("theta", "part", "ranges", "support_init", "stats")


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _graphs(name):
    spec = GOLDEN["graphs"][name]
    a = spec["args"]
    return (getattr(tgraph, spec["gen"])(a[0], a[1], a[2], seed=a[3]),
            getattr(jgraph, spec["gen"])(a[0], a[1], a[2], seed=a[3]))


# ---------------------------------------------------------------------
# layouts (numpy) against the JAX package's
# ---------------------------------------------------------------------
def _concat(states, fields):
    """The port's per-rank blocks, concatenated field by field."""
    return {f: torch.cat([getattr(s, f) for s in states]).numpy()
            for f in fields}


@pytest.mark.parametrize("n_dev", [1, 4, 8, 512])
@pytest.mark.parametrize("name", ["pl100", "tiny"])
def test_layouts_equal_jax(name, n_dev):
    tg, jg = _graphs(name)
    tbe, jbe = tbuild_beindex(tg), jbuild_beindex(jg)
    twed, jwed = tcsr.build_wedges(tg), jcsr.build_wedges(jg)
    cpu = torch.device("cpu")

    states = [tdist.shard_links(tbe, tg.m, n_dev, r, cpu)
              for r in range(n_dev)]
    js = jdist.shard_links(jbe, jg.m, n_dev)
    for f, v in _concat(states, ("le", "lt", "lb", "alive_link")).items():
        assert np.array_equal(v, np.asarray(getattr(js, f))), f
    for f in ("k_alive", "support"):
        assert np.array_equal(getattr(states[-1], f).numpy(),
                              np.asarray(getattr(js, f))), f

    states = [tdist.shard_wedges(twed, n_dev, r, cpu) for r in range(n_dev)]
    js = jdist.shard_wedges(jwed, n_dev)
    for f, v in _concat(states, ("we1", "we2", "wp", "alive_w")).items():
        assert np.array_equal(v, np.asarray(getattr(js, f))), f
    for f in ("W_pad", "support"):
        assert np.array_equal(getattr(states[-1], f).numpy(),
                              np.asarray(getattr(js, f))), f

    pairs = [
        (tdist.shard_links_bloom_aligned(tbe, tg.m, n_dev),
         jdist.shard_links_bloom_aligned(jbe, jg.m, n_dev)),
        (tdist.shard_wedges_pair_aligned(twed, n_dev),
         jdist.shard_wedges_pair_aligned(jwed, n_dev)),
    ] + [
        (tdist.shard_tip_pairs(twed, twed.pair_butterflies0(), n_dev, a),
         jdist.shard_tip_pairs(jwed, jwed.pair_butterflies0(), n_dev, a))
        for a in (False, True)]
    for t, j in pairs:
        assert t.keys() == j.keys()
        for k in t:
            assert np.array_equal(np.asarray(t[k]), np.asarray(j[k])), k


def test_greedy_balance_and_beindex_packer_equal_jax():
    tg, jg = _graphs("pl100")
    rng = np.random.default_rng(0)
    for n_dev in (1, 3, 8, 512):
        counts = rng.integers(0, 50, size=200)
        for t, j in zip(tdist._greedy_balance(counts, n_dev),
                        jdist._greedy_balance(counts, n_dev)):
            assert np.array_equal(t, j)
    res = jwing(jg, P=6, engine="beindex")
    tp = tdist.pack_fd_partitions(tg, tbuild_beindex(tg), res.part,
                                  res.support_init, res.stats.p_effective)
    jp = jdist.pack_fd_partitions(jg, jbuild_beindex(jg), res.part,
                                  res.support_init, res.stats.p_effective)
    assert tp.keys() == jp.keys()
    for k in tp:
        assert np.array_equal(np.asarray(tp[k]), np.asarray(jp[k])), k


def test_tiny_graph_has_all_padding_shards():
    """The ``tiny`` golden graph leaves whole shards of padding at 8
    ranks, so the 8-rank replay covers them: a rank whose block names
    only sentinel rows."""
    tg, _ = _graphs("tiny")
    wed = tcsr.build_wedges(tg)
    assert wed.n_pairs < 8 and tg.n_u < 8
    pal = tdist.shard_wedges_pair_aligned(wed, 8)
    assert (~pal["alive"].any(axis=1)).any()
    tip = tdist.shard_tip_pairs(wed, wed.pair_butterflies0(), 8, True)
    assert ((tip["dst"] == tg.n_u).all(axis=1)).any()


# ---------------------------------------------------------------------
# the cells, on the ranks of gloo process groups
# ---------------------------------------------------------------------
RUNS = {  # label: (world, meshes, obs on too)
    "w1": (1, ("1d", "2d"), False),
    "w4": (4, ("1d",), True),
    "w8": (8, ("1d", "2d"), False),
}


@pytest.fixture(scope="module")
def replays(tmp_path_factory):
    """Every golden cell replayed on every rank of each run."""
    out = {}
    for label, (world, meshes, obs_on) in RUNS.items():
        d = tmp_path_factory.mktemp(label)
        cmd = [sys.executable, os.path.join(GOLDENS, "distributed_replay.py"),
               "--world", str(world), "--mesh", *meshes, "--out", str(d)]
        if obs_on:
            cmd.append("--obs")
        p = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                           cwd=ROOT, timeout=600)
        assert p.returncode == 0, p.stderr[-4000:]
        out[label] = [json.load(open(d / f"rank{r}.json"))
                      for r in range(world)]
    return out


MESH_RUNS = [("w1", "1d"), ("w1", "2d"), ("w4", "1d"), ("w4", "1d+obs"),
             ("w8", "1d"), ("w8", "2d")]


@pytest.mark.parametrize("label,mesh", MESH_RUNS)
def test_cells_bit_equal_jax(replays, label, mesh):
    """θ, part, ranges, ⋈init and the stats of every cell equal the JAX
    package's, on every rank (each holds the whole result)."""
    ranks = replays[label]
    world = RUNS[label][0]
    want_shape = {"1d": [world], "2d": {1: [1, 1], 8: [2, 4]}.get(world),
                  "1d+obs": [world]}[mesh]
    assert ranks[0][mesh]["shape"] == want_shape
    for r in ranks[1:]:
        assert r[mesh] == ranks[0][mesh]
    cells = ranks[0][mesh]["cells"]
    assert cells.keys() == GOLDEN["results"].keys()
    for key, want in GOLDEN["results"].items():
        got = cells[key]
        assert got["n_dev"] == world, key
        for f in FIELDS:
            assert got[f] == want[f], (key, f)


def _per_round(key: str, mesh: str) -> int:
    """Collectives a CD round: 2 for the beindex link and csr wedge
    layouts, 1 for the aligned ones and for tip; each a stage per mesh
    dimension.  (The dense tip CD is counted apart.)"""
    kind, engine, layout = key.split(":")[1].split("/")[:3]
    k = 2 if kind == "wing" and layout == "flat" else 1
    return k * (2 if mesh == "2d" else 1)


@pytest.mark.parametrize("label,mesh", MESH_RUNS)
def test_collective_counts(replays, label, mesh):
    """2 / 1 / 1 / 1 / 2 collectives a CD round (link, bloom-aligned,
    pair-aligned, tip, csr wedge), none in FD, one result gather (none
    for the vmapped tip FD, which every rank runs whole) — and not one
    ``torch.distributed`` call outside the module's helpers."""
    for key, got in replays[label][0][mesh]["cells"].items():
        rho = got["stats"]["rho_cd"]
        c = got["counts"]
        assert c["fd"] == 0, key
        assert got["calls"] == sum(c.values()), key
        if "/dense/" in key:
            # A, alive and the recounted rows, each round and at ⋈init
            assert c["cd"] == 3 * (rho + 1), key
        else:
            assert c["cd"] == _per_round(key, mesh) * rho, key
        assert c["result"] == (0 if "/vmapped/" in key else 1), key


def test_obs_on_timeline_equals_jax_and_off_changes_nothing(replays):
    off = replays["w4"][0]["1d"]["cells"]
    on = replays["w4"][0]["1d+obs"]["cells"]
    for key, want in GOLDEN["results"].items():
        assert off[key]["timeline"] is None
        assert on[key]["timeline"] == want["timeline"], key
        for f in (*FIELDS, "counts", "calls"):
            assert on[key][f] == off[key][f], (key, f)


def test_ranks_import_no_jax(replays):
    for ranks in replays.values():
        assert not any(r["jax_imported"] for r in ranks)


# ---------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------
BAD_WING = [dict(engine="dense"), dict(engine="beindex", pair_aligned=True),
            dict(engine="csr", bloom_aligned=True)]
BAD_TIP = [dict(engine="beindex"), dict(fd_driver="host"),
           dict(engine="dense", aligned=True),
           dict(engine="dense", fd_driver="vmapped")]


def _raised(fn, *a, **k):
    with pytest.raises(ValueError) as e:
        fn(*a, **k)
    return str(e.value)


@pytest.mark.parametrize("kw", BAD_WING)
def test_wing_value_errors_equal_jax(kw):
    tg, jg = _graphs("tiny")
    assert (_raised(tdist.distributed_wing_decomposition, tg, None, **kw)
            == _raised(jdist.distributed_wing_decomposition, jg, None, **kw))


@pytest.mark.parametrize("kw", BAD_TIP)
def test_tip_value_errors_equal_jax(kw):
    tg, jg = _graphs("tiny")
    assert (_raised(tdist.distributed_tip_decomposition, tg, None, **kw)
            == _raised(jdist.distributed_tip_decomposition, jg, None, **kw))


def test_be_with_csr_refused_and_mesh_2d_groups_equal_jax():
    tg, jg = _graphs("tiny")
    assert (_raised(tdist.distributed_wing_decomposition, tg, None,
                    engine="csr", be=tbuild_beindex(tg))
            == _raised(jdist.distributed_wing_decomposition, jg, None,
                       engine="csr", be=jbuild_beindex(jg)))
    from repro.launch import mesh as jmesh

    assert (_raised(tmesh.make_peel_mesh_2d, 8, groups=3)
            == _raised(jmesh.make_peel_mesh_2d, 8, groups=3))


@pytest.mark.parametrize("flags,n_dev", [
    (["--aligned"], 1),
    (["--kind", "wing", "--engine", "csr", "--fused-fd"], 4),
    (["--kind", "wing", "--engine", "dense"], 4),
    (["--kind", "wing", "--engine", "csr", "--fd-driver", "vmapped"], 4),
    (["--kind", "tip", "--fd-driver", "host"], 4),
    (["--kind", "tip", "--use-pallas"], 4),
    (["--kind", "tip", "--edges", "x.tsv"], 4),
    (["--kind", "tip", "--engine", "dense", "--aligned"], 4),
])
def test_cli_refusals_equal_jax(flags, n_dev):
    def message(validate):
        args = tcli.build_parser().parse_args(flags)
        with pytest.raises(SystemExit) as e:
            validate(args, n_dev)
        return str(e.value)

    assert message(tcli._validate) == message(jcli._validate)


def test_init_peel_group_refuses(monkeypatch):
    """No quiet switch: ``cuda`` with no card, ``nccl`` on the CPU and
    ``nccl`` with more ranks than cards all raise before any group is
    opened."""
    import torch.distributed as dist

    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tmesh.init_peel_group("cuda")
    with pytest.raises(ValueError, match="gloo"):
        tmesh.init_peel_group("cpu", backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--backend gloo"):
        tmesh.init_peel_group("cuda")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------
# the CLI under torch.distributed.run, and --dryrun
# ---------------------------------------------------------------------
def _torchrun(flags, tmp):
    out = os.path.join(tmp, "out.json")
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.peel",
         "--device", "cpu", "--backend", "gloo", *flags, "--out", out],
        env=_env(), capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    with open(out) as f:
        return json.load(f), p.stdout


@pytest.mark.parametrize("i", range(len(GOLDEN["cli"])))
def test_cli_four_gloo_ranks_equal_jax_cli(i, tmp_path):
    """``launch.peel`` on 4 gloo ranks writes the ``--out`` of
    ``repro.launch.peel`` on 8 devices: θ and every stat but n_dev."""
    want = GOLDEN["cli"][i]
    flags = want["flags"]
    hier = flags == ["--kind", "tip", "--aligned"]
    extra = ["--emit-hierarchy", str(tmp_path / "d.npz")] if hier else []
    got, stdout = _torchrun(flags + extra, str(tmp_path))
    assert got["theta"] == want["theta"]
    drop = ("n_dev",)
    assert ({k: v for k, v in got["stats"].items() if k not in drop}
            == {k: v for k, v in want["stats"].items() if k not in drop})
    assert got["stats"]["n_dev"] == 4
    # rank 0 alone prints
    assert stdout.count("[peel] theta:") == 1
    if hier:
        from repro_torch.hierarchy import load_hierarchy

        tcli.main([*flags[:2], "--device", "cpu", "--emit-hierarchy",
                   str(tmp_path / "s.npz")])
        hd = load_hierarchy(str(tmp_path / "d.npz"))
        hs = load_hierarchy(str(tmp_path / "s.npz"))
        for f in ("theta", "node_level", "parent", "entity_node",
                  "member_off", "member_ids", "child_off", "child_ids",
                  "tin", "tout", "node_m", "node_nu", "node_nv",
                  "density"):
            assert np.array_equal(getattr(hd, f), getattr(hs, f)), f
        assert set(hd.meta) == set(hs.meta)
        assert hd.meta["stats"]["engine"] == "csr"
        assert hd.meta["stats"]["side"] == "u"


def test_dryrun():
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.peel", "--dryrun"],
        env=_env(), capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    assert "512 fake ranks" in p.stdout
    assert p.stdout.count("✓") == 13
    assert "all structural checks passed" in p.stdout


# ---------------------------------------------------------------------
# csr.edge_butterflies_csr (ROADMAP item 17)
# ---------------------------------------------------------------------
EB_GRAPHS = [((30, 24, 140), s, False) for s in range(3)] + [
    ((24, 20, 110), s, True) for s in range(2)] + [
    ((60, 45, 350), s, True) for s in range(2)]


def _edge_butterflies_both(tw, jw, alive):
    import jax.numpy as jnp

    out = []
    for use_pallas in (False, True):
        got = tcsr.edge_butterflies_csr(
            tw, None if alive is None else torch.from_numpy(alive),
            use_pallas=use_pallas, device="cpu")
        want = jcsr.edge_butterflies_csr(
            jw, None if alive is None else jnp.asarray(alive),
            use_pallas=use_pallas, interpret=True)
        assert got.dtype == torch.int32 and got.shape == (tw.m,)
        assert np.array_equal(got.numpy(), np.asarray(want)), use_pallas
        out.append(got)
    return out


@pytest.mark.parametrize("shape,seed,masked", EB_GRAPHS)
def test_edge_butterflies_csr_equals_jax(shape, seed, masked):
    """Both routes (plain, and ``use_pallas``: the ``wedge_count``
    kernel's plain version here) equal JAX's, plain and Pallas in
    interpret mode, on the graphs of ``tests/test_csr.py``."""
    tg = tgraph.random_bipartite(*shape, seed=seed)
    jg = jgraph.random_bipartite(*shape, seed=seed)
    tw, jw = tcsr.build_wedges(tg), jcsr.build_wedges(jg)
    alive = (np.random.default_rng(seed).random(tg.m) > 0.3 if masked
             else None)
    got, _ = _edge_butterflies_both(tw, jw, alive)
    if alive is None:
        assert np.array_equal(got.numpy(), tcsr.edge_butterflies0(tw))


def test_edge_butterflies_csr_without_wedges():
    """No wedge: zeros of length m, as JAX's ``zeros((max(m, 1),))[:m]``."""
    edges = np.array([[0, 0], [1, 1], [2, 2]])
    tw = tcsr.build_wedges(tgraph.BipartiteGraph.from_edges(3, 3, edges))
    jw = jcsr.build_wedges(jgraph.BipartiteGraph.from_edges(3, 3, edges))
    assert tw.n_wedges == 0
    for got in _edge_butterflies_both(tw, jw, None):
        assert got.tolist() == [0, 0, 0]
