"""The port's LM dry-run, meshes and ``remesh`` against the JAX package.

* ``launch.dryrun.dryrun_cell`` on fake process groups of 256 and 512
  ranks, for every architecture and shape set: the status and skip
  reason of JAX's ``shape_applicable``, and ``mem.argument_bytes`` equal
  to Σ ``NamedSharding.shard_shape`` × itemsize over the trees the JAX
  dry-run places (parameters, optimizer state, batch; cache, token,
  length), its ``in_shardings`` rebuilt on a ``Mesh`` of the one CPU
  device repeated; one cell a family counted (FLOPs, bytes, collective
  bytes); the CLI and ``run_all``'s resumable JSON.
* ``launch.mesh``'s LM meshes on fake groups, and their refusals.
* ``train.elastic.remesh`` on 8 gloo ranks (``tests/goldens/
  remesh_replay.py``) from (2, 4) to ranks 0–3 as (2, 2), each rank's
  shards equal to the slices JAX gives that device (a JAX run on 8
  forced host devices, as ``tests/test_train.py`` runs it), and at world
  1 followed by a train step equal to the plain one.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import repro.models as JM
from repro.configs import ARCHS, get_config as jget
from repro.sharding import (batch_shardings as jbatch,
                            cache_shardings as jcache,
                            param_shardings as jparam)
from repro.train.optimizer import OptState as JOptState
from repro.train.optimizer import abstract_opt_state as jabstract_opt
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import dryrun_cell
from repro_torch.launch.mesh import (PRODUCTION_MESHES, fake_group,
                                     make_local_mesh,
                                     make_production_mesh)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _env(**kw):
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1", **kw)


def jax_argument_bytes(arch, shape, multi_pod):
    """Per-device bytes of what the JAX dry-run places for the cell: its
    ``in_shardings`` over its abstract arguments."""
    dims, names = PRODUCTION_MESHES[multi_pod]
    n = int(np.prod(dims))
    mesh = Mesh(np.array(jax.devices() * n)[:n].reshape(dims), names)
    cfg = jget(arch)
    kind = JM.SHAPE_SETS[shape]["kind"]
    pabs = JM.abstract_params(cfg, jnp.bfloat16)
    p_sh = jparam(JM.logical_axes(cfg), pabs, mesh)
    placed = [(pabs, p_sh)]
    if kind == "train":
        placed.append((jabstract_opt(pabs), JOptState(
            mu=p_sh, nu=p_sh, step=NamedSharding(mesh, P()))))
    if kind in ("train", "prefill"):
        batch = JM.input_specs(cfg, shape)
        placed.append((batch, jbatch(batch, mesh)))
    else:
        spec = JM.input_specs(cfg, shape)
        placed += [
            (spec["cache"], jcache(spec["cache"], mesh, cfg)),
            (spec["token"], jbatch(dict(token=spec["token"]), mesh)["token"]),
            (spec["length"], NamedSharding(mesh, P()))]
    total = 0
    for tree, shs in placed:
        leaves = jax.tree.leaves(tree)
        sh = jax.tree.leaves(shs, is_leaf=lambda x: isinstance(
            x, NamedSharding))
        assert len(leaves) == len(sh)
        for x, s in zip(leaves, sh):
            total += int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
    return total


# ---------------------------------------------------------------------
# the dry-run, every cell
# ---------------------------------------------------------------------
# the cells whose step the test runs and counts at full depth, one a
# family, on one pod (counting all 80 cells at full depth takes minutes;
# the roofline tests hold the counts themselves, tests/test_torch_roofline.py)
COUNTED = {("tinyllama_1_1b", "train_4k"), ("dbrx_132b", "decode_32k"),
           ("xlstm_1_3b", "decode_32k"), ("zamba2_7b", "decode_32k"),
           ("whisper_large_v3", "decode_32k"), ("qwen2_vl_72b", "decode_32k")}
COUNT_KEYS = ("flops", "bytes_accessed", "collective_bytes", "time_count_s")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_cell_equals_jax(arch, shape):
    """On 256 and 512 fake ranks: a skipped cell has JAX's reason and
    nothing else; a placed one its kind, rank count and the exact
    per-device argument bytes JAX's shardings give.  One cell a family
    (``COUNTED``, one pod) also runs its step: its record has JAX's
    ``flops``, ``bytes_accessed`` and ``collective_bytes`` (by JAX's
    kinds), positive, and its outputs' bytes; the rest are placed only
    (``count=False``), with none of those keys."""
    from repro_torch.launch.hlo_analysis import COLLECTIVES

    ok, why = JM.shape_applicable(jget(arch), shape)
    for mp in (False, True):
        count = (arch, shape) in COUNTED and not mp
        rec = dryrun_cell(arch, shape, multi_pod=mp, verbose=False,
                          count=count)
        if not ok:
            assert rec == dict(arch=arch, shape=shape, multi_pod=mp,
                               status="skipped", reason=why)
            continue
        counted = {k: rec.pop(k) for k in COUNT_KEYS if k in rec}
        out_bytes = rec["mem"].pop("output_bytes", None)
        assert rec == dict(
            arch=arch, shape=shape, multi_pod=mp, status="ok",
            kind=JM.SHAPE_SETS[shape]["kind"], n_devices=512 if mp else 256,
            tags="", mem=dict(argument_bytes=jax_argument_bytes(
                arch, shape, mp)))
        if not count:
            assert counted == {} and out_bytes is None
            continue
        assert set(counted) == set(COUNT_KEYS)
        assert counted["flops"] > 0 and counted["bytes_accessed"] > 0
        assert set(counted["collective_bytes"]) <= set(COLLECTIVES)
        assert all(v > 0 for v in counted["collective_bytes"].values())
        assert out_bytes > 0
    assert not dist.is_initialized()


def test_dryrun_overrides_and_an_open_group():
    """``cfg_overrides`` reach the placed tree (half the layers, fewer
    bytes); a cell refuses to run inside a process group already open."""
    full = dryrun_cell("tinyllama_1_1b", "prefill_32k", verbose=False)
    half = dryrun_cell("tinyllama_1_1b", "prefill_32k", verbose=False,
                       cfg_overrides=dict(n_layers=11))
    assert half["mem"]["argument_bytes"] < full["mem"]["argument_bytes"]
    with fake_group(4):
        with pytest.raises(RuntimeError, match="already open"):
            dryrun_cell("tinyllama_1_1b", "train_4k", verbose=False)


def test_dryrun_cli_and_run_all(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch --shape`` prints the
    cell's record, counted; ``main`` without both runs ``run_all`` into
    ``--out`` (resumable: a second run adds nothing; microbatches tag a
    new set), the pod filters honoured — with ``--no-count`` (placement
    only: xLSTM's train_4k alone counts its sLSTM loop for minutes)."""
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama_1_1b", "--shape", "train_4k", "--multi-pod"],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    rec = json.loads(p.stdout[p.stdout.index("{"):])
    assert rec["mem"]["argument_bytes"] == jax_argument_bytes(
        "tinyllama_1_1b", "train_4k", True)
    assert rec["flops"] > 0 and rec["collective_bytes"]
    out = tmp_path / "dry" / "results.json"
    argv = ["--arch", "xlstm_1_3b", "--single-pod-only", "--no-count",
            "--out", str(out)]
    dryrun.main(argv)
    recs = json.loads(out.read_text())
    assert [(r["shape"], r["multi_pod"], r["status"]) for r in recs] == [
        (s, False, "ok") for s in SHAPES]
    dryrun.main(argv)
    assert json.loads(out.read_text()) == recs
    dryrun.main(["--shape", "decode_32k", "--multi-pod-only",
                 "--microbatches", "2", "--no-count", "--out", str(out)])
    more = json.loads(out.read_text())[len(recs):]
    assert [(r["arch"], r["multi_pod"], r["tags"]) for r in more] == [
        (a, True, "mb2") for a in ARCHS]
    capsys.readouterr()


# ---------------------------------------------------------------------
# the LM meshes
# ---------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    """16×16 ("data", "model") / 2×16×16 ("pod", "data", "model") on a
    fake group of that many ranks; any other size is refused."""
    dims, names = PRODUCTION_MESHES[multi_pod]
    with fake_group(int(np.prod(dims))):
        m = make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert tuple(m.shape) == dims and m.mesh_dim_names == names
    with fake_group(8):
        with pytest.raises(ValueError, match="takes"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")


@pytest.mark.parametrize("n,dims", [(1, (1, 1)), (4, (2, 2)), (6, (3, 2)),
                                    (7, (7, 1)), (8, (4, 2))])
def test_local_mesh(n, dims):
    """JAX's rule: (1, 1) on one rank, else (n // m, m), m = 2 if n is
    even; a process group is needed."""
    with fake_group(n):
        m = make_local_mesh(device="cpu")
        assert tuple(m.shape) == dims
        assert m.mesh_dim_names == ("data", "model")
    with pytest.raises(RuntimeError, match="process group"):
        make_local_mesh(device="cpu")


# ---------------------------------------------------------------------
# remesh
# ---------------------------------------------------------------------
_JAX_REMESH = textwrap.dedent("""
    import json, os, sys
    import jax, jax.numpy as jnp, numpy as np
    import repro.models as M
    from repro.configs import get_config
    from repro.models.config import reduced
    from repro.train.optimizer import OptState, adamw_init
    from repro.train.elastic import remesh
    out = sys.argv[1]
    cfg = reduced(get_config("tinyllama_1_1b"))
    params = M.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    opt = adamw_init(params)
    # moments of their own values, so a misplaced shard shows
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    leaves, tdef = jax.tree.flatten(params)
    mu = [jax.random.normal(jax.random.fold_in(k1, i), x.shape)
          for i, x in enumerate(leaves)]
    nu = [jax.random.uniform(jax.random.fold_in(k2, i), x.shape)
          for i, x in enumerate(leaves)]
    opt = OptState(mu=jax.tree.unflatten(tdef, mu),
                   nu=jax.tree.unflatten(tdef, nu), step=opt.step + 7)
    axes = M.logical_axes(cfg)
    devs = np.array(jax.devices())
    m8 = jax.sharding.Mesh(devs.reshape(2, 4), ("data", "model"))
    p8, o8 = remesh(params, opt, axes, m8)
    m4 = jax.sharding.Mesh(devs[:4].reshape(2, 2), ("data", "model"))
    p4, o4 = remesh(p8, o8, axes, m4)
    def items(tree, name):
        return [(name + "/" + ".".join(k.key for k in kp), x)
                for kp, x in jax.tree_util.tree_leaves_with_path(tree)]
    arrays, slices = {}, {}
    for stage, p, o in (("m8", p8, o8), ("m4", p4, o4)):
        slices[stage] = {}
        for name, tree in (("params", p), ("mu", o.mu), ("nu", o.nu)):
            for key, x in items(tree, name):
                arrays[key] = np.asarray(x)
                slices[stage][key] = {
                    str(d.id): [list(s.indices(n))[:2]
                                for s, n in zip(idx, x.shape)]
                    for d, idx in x.sharding.devices_indices_map(
                        x.shape).items()}
    for name, tree in (("params", params), ("mu", opt.mu), ("nu", opt.nu)):
        for key, x in items(tree, name):
            assert np.array_equal(arrays[key], np.asarray(x)), key
    # a batch over ("pod", "data") on a 2x2x2 mesh: one dim, two mesh axes
    from repro.sharding import batch_shardings
    m3 = jax.sharding.Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model"))
    x = jnp.arange(8 * 6, dtype=jnp.int32).reshape(8, 6)
    sh = batch_shardings(dict(tokens=x), m3)["tokens"]
    assert tuple(sh.spec) == (("pod", "data"), None)
    arrays["pod/tokens"] = np.asarray(x)
    slices["pod"] = {"pod/tokens": {
        str(d.id): [list(s.indices(n))[:2] for s, n in zip(idx, x.shape)]
        for d, idx in sh.devices_indices_map(x.shape).items()}}
    np.savez(os.path.join(out, "state.npz"), **arrays)
    json.dump(slices, open(os.path.join(out, "slices.json"), "w"))
    print("JAX_REMESH_OK", len(arrays))
""")


def test_remesh_on_8_gloo_ranks_equals_jax_shards(tmp_path):
    """(2, 4) → ranks 0–3 as (2, 2): every rank's shard of every
    parameter and moment is the slice JAX gives that device (none on a
    lost rank), and the full values and ``step`` are unchanged; a batch
    over ("pod", "data") on a 2×2×2 mesh is split pod-major, as JAX
    splits it."""
    case = str(tmp_path)
    p = subprocess.run(
        [sys.executable, "-c", _JAX_REMESH, case], cwd=ROOT,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0 and "JAX_REMESH_OK" in p.stdout, p.stderr[-3000:]
    slices = json.load(open(tmp_path / "slices.json"))
    # the layouts are not all trivial: some leaf splits over both axes
    assert any(len(v) == 8 and len({json.dumps(s) for s in v.values()}) == 8
               for v in slices["m8"].values())
    p = subprocess.run(
        [sys.executable, os.path.join(GOLDENS, "remesh_replay.py"),
         "--case", case], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    n_leaves = 2 * len(slices["m8"]) + 1
    for r in range(8):
        got = json.load(open(tmp_path / f"rank{r}.json"))
        assert got["bad"] == [], (r, got["bad"][:5])
        assert got["checked"] == n_leaves
        assert got["step"] == (7 if r < 4 else None)


def test_remesh_world_one_then_a_train_step(tmp_path):
    """At world 1 (gloo, in process): ``remesh`` of reduced TinyLlama's
    parameters and ``adamw_init`` state onto ``make_local_mesh`` keeps
    every leaf equal, and a train step from the re-placed state (its
    local shards, the whole tensors at world 1) equals the step from
    the plain tensors; DTensor leaves re-place from a mesh onto
    another."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.models import logical_axes, reduced
    from repro_torch.models.convert import numpy_params, params_from_numpy
    from repro_torch.train import (AdamWConfig, TrainConfig, adamw_init,
                                   make_train_step, remesh)
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = reduced(get_config("tinyllama_1_1b"), n_layers=2)
    params = params_from_numpy(numpy_params(cfg, seed=3), cfg, device="cpu")
    opt = adamw_init(params)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, TrainConfig(opt=AdamWConfig(
        lr=1e-2, warmup_steps=1)))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(device="cpu")
        p1, o1 = remesh(params, opt, logical_axes(cfg), mesh)
        p2, o2 = remesh(p1, o1, logical_axes(cfg), mesh)
        flat = lambda p, o: tree_leaves(p) + tree_leaves(o)
        for a, b in zip(flat(params, opt), flat(p2, o2), strict=True):
            assert isinstance(b, DTensor) and torch.equal(b.to_local(), a)
        local = lambda t: tree_map(lambda d: d.to_local(), t)
        got = step(local(p2), type(o2)(*map(local, o2)), batch)
        want = step(params, opt, batch)
        for a, b in zip(flat(*got[:2]), flat(*want[:2]), strict=True):
            assert torch.equal(a, b)
        assert got[2]["loss"].item() == want[2]["loss"].item()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------
# chip_smoke.py's phase 17, rehearsed
# ---------------------------------------------------------------------
def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_lm_mesh_phase_rehearsed_on_cpu(tmp_path, monkeypatch):
    """Phase 17 on the CPU (gloo at world 1, reduced TinyLlama; the
    dry-run CLI at full width, as on the card; the roofline CLI on
    decode_32k only; the four ranks at reduced widths): green, and its
    argument bytes, ``LM_MESH``'s constants, are JAX's; the mesh path's
    step, prefill and decode bit-equal to the plain ones; the four
    ranks' loss and gradients within their gates, on the CPU (no card:
    the probe says so); the roofline's cells and the one-card count
    there; a ``remesh`` that moves one value of a leaf fails it."""
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    from repro_torch.train import elastic

    smoke = _smoke()
    want = smoke.LM_MESH["argument_bytes"]
    assert want == {"16x16": jax_argument_bytes("tinyllama_1_1b", "train_4k",
                                                False),
                    "2x16x16": jax_argument_bytes("tinyllama_1_1b",
                                                  "train_4k", True)}
    spec = dict(smoke.LM_MESH, cfg=reduced(get_config("tinyllama_1_1b"),
                                           n_layers=2), seq=32,
                roofline=["--arch", "tinyllama_1_1b", "--shape",
                          "decode_32k"],
                card=dict(reduced=True, depth=2, batch=4, seq=32))
    (tmp_path / "a").mkdir()
    info = smoke.phase_lm_mesh("cpu", str(tmp_path / "a"), spec)
    assert info["dryrun"]["train_4k 16x16"] == want["16x16"]
    assert info["dryrun"]["long_500k 16x16"] == "skipped"
    assert info["loss"][0] == info["loss"][1]
    assert info["prefill_equal"] and all(info["decode_equal"])
    ranks = info["ranks"]
    assert ranks["device"] == "cpu" and ranks["probe_cuda"]["skipped"]
    assert ranks["worst_rel_l2"] <= smoke.TRAIN_GRAD_RTOL
    assert set(ranks["collective_counts"]) <= {"all-gather", "all-reduce",
                                               "reduce-scatter", "all-to-all"}
    assert {k: v if isinstance(v, str) else v["bottleneck"]
            for k, v in info["roofline"].items()} == {
        "decode_32k 16x16": "collective", "decode_32k 2x16x16": "collective"}
    assert info["one_card"]["flops"] > 0
    assert not dist.is_initialized()
    real = elastic.remesh

    def lossy(params, opt, axes, mesh):
        from torch.distributed.tensor import distribute_tensor

        p, o = real(params, opt, axes, mesh)
        bad = params["embed"].clone()
        bad[-1] += 1
        p["embed"] = distribute_tensor(bad, mesh, p["embed"].placements,
                                       src_data_rank=None)
        return p, o
    monkeypatch.setattr("repro_torch.train.remesh", lossy)
    (tmp_path / "b").mkdir()
    with pytest.raises(AssertionError, match="not its input"):
        smoke.phase_lm_mesh("cpu", str(tmp_path / "b"), spec)
    assert not dist.is_initialized()
