"""Sharded LM compute in the port against the unsharded port and the
JAX package.

* ``models.layers.constrain`` filters an activation spec as JAX's
  ``constrain`` does under ``set_mesh`` (a JAX run on 8 forced host
  devices captures the spec it hands ``with_sharding_constraint``), on
  three meshes, for every spec the model uses; with no mesh, or on a
  plain tensor, it returns its argument itself.
* All ten reduced architectures on 8 gloo ranks of a (2, 4) mesh
  (``tests/goldens/shard_compute_replay.py``; ``check_archs_on_8_gloo_
  ranks``, run by ``tests/test_torch_shard_dense.py``, ``_moe.py`` and
  ``_recurrent.py``): the sharded train step's
  loss within rtol 1e-5 of the unsharded one and of JAX's sharded loss
  (``tests/goldens/torch_shard_compute.json``), every gradient leaf,
  updated parameter and moment within atol 1e-5 + rtol 1e-4 (the
  unsharded step's precedent, ``tests/test_torch_train.py``; the SSM and
  hybrid families' gradients at their own precedent, relative L2 2e-4 a
  leaf, ``tests/test_torch_ssm.py``: they amplify f32 rounding), the
  prefill logits and three decode steps' within 1e-5 relative L2 (the
  SSM and hybrid families' within that 2e-4: Zamba2's move 1.2e-5),
  MoE's dispatch integers equal, and every rank's shard of every
  parameter and moment JAX's slice.
* ``flash_attention`` on ``DTensor``s: a rank whose query heads are a
  shard and whose KV heads are whole pairs each query head with its
  global KV head (the kernel's own ``h // (H/KVH)`` would not).
* World 1 (gloo, in process): the step, prefill and decode on placed
  ``DTensor``s equal the plain ones bit for bit; microbatches and the
  int8 compressor on ``DTensor``s too.
* The train and serve CLIs on 4 gloo ranks under
  ``torch.distributed.run`` against one process.
"""
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
SSM_GRAD_RTOL = 2e-4       # tests/test_torch_ssm.py's, relative L2 a leaf
REL_L2 = 1e-5


def _env(**kw):
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1", **kw)


# ---------------------------------------------------------------------
# constrain against JAX
# ---------------------------------------------------------------------
# every activation spec the model code constrains to (DP_AXES spelt out)
DP = ("pod", "data")
SPECS = [(DP, None, None), (DP, None), (DP, None, "model"), (DP, "model"),
         (DP, "model", None), (DP, "model", None, None),
         (DP, None, None, None)]
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "4x2 no pod": ((4, 2), ("data", "model")),
          "8 data only": ((8,), ("data",))}

_JAX_CONSTRAIN = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    import repro.models.layers as L
    from repro.sharding.compat import set_mesh
    meshes, specs = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    seen = []
    L.jax.lax.with_sharding_constraint = lambda x, s: seen.append(
        [list(e) if isinstance(e, tuple) else e for e in s]) or x
    out = {}
    for name, (dims, names) in meshes.items():
        n = int(np.prod(dims))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(dims), tuple(names))
        out[name] = []
        with set_mesh(mesh):
            for spec in specs:
                spec = tuple(tuple(e) if isinstance(e, list) else e
                             for e in spec)
                seen.clear()
                L.constrain(jnp.zeros((8,) * len(spec)), spec)
                out[name].append(seen[0])
    print(json.dumps(out))
""")


def _norm(entry):
    """A JAX spec entry in the port's convention (a one-name tuple as
    the name, an empty one as None)."""
    if isinstance(entry, (list, tuple)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


def test_constrain_filters_specs_as_jax():
    """For every spec the model uses, on (2, 4), (2, 2, 2), a mesh with
    no ``"pod"`` and one with only ``"data"``: ``constrain_spec`` equals
    the spec JAX's ``constrain`` passes to ``with_sharding_constraint``
    under ``set_mesh`` on 8 forced host devices."""
    from repro_torch.models.layers import constrain_spec

    p = subprocess.run(
        [sys.executable, "-c", _JAX_CONSTRAIN,
         json.dumps({k: [list(d), list(n)] for k, (d, n) in MESHES.items()}),
         json.dumps(SPECS)], cwd=ROOT, capture_output=True, text=True,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"), timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    jax_specs = json.loads(p.stdout.strip().splitlines()[-1])
    for name, (dims, names) in MESHES.items():
        for spec, want in zip(SPECS, jax_specs[name], strict=True):
            got = constrain_spec(spec, names)
            assert got == tuple(_norm(e) for e in want), (name, spec, got,
                                                          want)


def test_constrain_without_a_mesh_is_the_identity():
    """No current mesh, or a plain tensor under one: the argument itself
    (the same object), so every single-device path is untouched."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import fake_group, make_local_mesh
    from repro_torch.models.layers import DP_AXES, constrain
    from repro_torch.sharding import (Sharding, current_mesh, distribute,
                                      use_mesh)

    x = torch.ones(4, 3)
    assert current_mesh() is None
    assert constrain(x, (DP_AXES, None)) is x
    with fake_group(4):
        mesh = make_local_mesh(device="cpu")
        d = distribute(x, Sharding(mesh, ("model",)))
        assert constrain(d, (DP_AXES, None)) is d   # no mesh entered
        with use_mesh(mesh):
            assert current_mesh() is mesh
            assert constrain(x, (DP_AXES, None)) is x
            y = constrain(d, (DP_AXES, None))
            assert isinstance(y, DTensor) and tuple(
                str(p) for p in y.placements) == ("S(0)", "R")
        assert current_mesh() is None


# ---------------------------------------------------------------------
# every reduced architecture on 8 gloo ranks
# ---------------------------------------------------------------------
GOLDEN = json.load(open(os.path.join(GOLDENS, "torch_shard_compute.json")))
GROUPS = {"dense and vlm": ["tinyllama_1_1b", "codeqwen1_5_7b", "gemma_2b",
                            "chatglm3_6b", "qwen2_vl_72b"],
          "moe": ["deepseek_v2_236b", "dbrx_132b"],
          "ssm, hybrid and audio": ["xlstm_1_3b", "zamba2_7b",
                                    "whisper_large_v3"]}


def check_archs_on_8_gloo_ranks(tmp_path, group):
    """Each architecture of ``GROUPS[group]`` on a (2, 4) mesh of 8 gloo
    ranks against the unsharded port in the same process and JAX's
    sharded step (see the module docstring for the gates); the tests are
    ``tests/test_torch_shard_dense.py``, ``tests/test_torch_shard_moe.py``
    and ``tests/test_torch_shard_recurrent.py``, a group a file, each
    inside two minutes on one worker."""
    from repro_torch.configs import get_config
    from repro_torch.models import logical_axes, reduced
    from repro_torch.train.tree import tree_leaves

    archs = GROUPS[group]
    p = subprocess.run(
        [sys.executable, os.path.join(GOLDENS, "shard_compute_replay.py"),
         "--case", str(tmp_path), "--archs", ",".join(archs)], cwd=ROOT,
        env=_env(), capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(8)]
    for arch in archs:
        cfg = reduced(get_config(arch))
        ssm = cfg.family in ("ssm", "hybrid")
        n_leaves = len(tree_leaves(logical_axes(cfg)))
        for r, rank in enumerate(ranks):
            rec = rank[arch]
            assert "error" not in rec, (arch, r, rec.get("trace"))
            lp, ls, lstep, lplain = rec["loss"]
            assert abs(ls - lp) <= 1e-5 * abs(lp), (arch, rec["loss"])
            assert lstep == ls and lplain == lp
            jax_loss = GOLDEN["archs"][arch]["loss"]
            assert abs(ls - jax_loss) <= 1e-5 * abs(jax_loss), (arch, ls,
                                                               jax_loss)
            if ssm:
                assert rec["grad_rel"] <= SSM_GRAD_RTOL, (arch, rec)
            else:
                assert rec["grad_err"] <= 1, (arch, rec)
            assert rec["param_err"] <= 1 and rec["moment_err"] <= 1, (arch,
                                                                      rec)
            assert rec["step"] == 1
            logits = SSM_GRAD_RTOL if ssm else REL_L2
            assert rec["prefill_rel"] <= logits, (arch, rec)
            assert max(rec["decode_rel"]) <= logits, (arch, rec)
            assert rec["bad_slices"] == [], (arch, r, rec["bad_slices"][:5])
            assert rec["slices_checked"] == 3 * n_leaves
            if cfg.is_moe:
                assert rec["moe_ints_equal"] and rec["moe_eb_rel"] == 0.0
    # some leaf splits over both mesh axes, so the slices are not trivial
    sl = GOLDEN["archs"][archs[0]]["slices"]
    assert any(len({json.dumps(v) for v in s.values()}) == 8
               for s in sl.values())


# ---------------------------------------------------------------------
# flash_attention on DTensors: the GQA pairing
# ---------------------------------------------------------------------
@pytest.mark.parametrize("rank", [0, 1, 3])
def test_sharded_attention_pairs_global_kv_heads(rank):
    """8 query heads over a 4-way ``"model"`` axis, 2 KV heads whole on
    every rank (2 does not divide 4): rank r's output is heads 2r, 2r + 1
    of the whole attention, each against its global KV head (h // 4) —
    the kernel's own mapping on the local shard (head j against KV head
    j) would pair them wrong, as the planted call shows."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.kernels import ops
    from repro_torch.models.layers import blockwise_attention
    from repro_torch.sharding import Sharding, distribute, use_mesh

    g = torch.Generator().manual_seed(rank)
    q = torch.randn(2, 8, 16, 32, generator=g)
    k = torch.randn(2, 2, 16, 32, generator=g)
    v = torch.randn(2, 2, 16, 32, generator=g)
    want = ops.flash_attention(q, k, v, causal=True, offset=0)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=4)
    try:
        mesh = init_device_mesh("cpu", (1, 4),
                                mesh_dim_names=("data", "model"))
        qd = distribute(q, Sharding(mesh, (None, "model")))
        kd, vd = (distribute(t, Sharding(mesh, ())) for t in (k, v))
        with use_mesh(mesh):
            out = blockwise_attention(qd, kd, vd, causal=True)
        local = out.to_local()
        heads = slice(2 * rank, 2 * rank + 2)
        torch.testing.assert_close(local, want[:, heads], rtol=1e-6,
                                   atol=1e-6)
        naive = ops.flash_attention(q[:, heads], k, v, causal=True, offset=0)
        assert not torch.allclose(naive, want[:, heads], atol=1e-3)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------
# world 1 in process: bit for bit
# ---------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "dbrx_132b",
                                  "xlstm_1_3b", "whisper_large_v3"])
def test_world_one_mesh_path_equals_the_plain_path(tmp_path, arch):
    """A world-1 gloo group, the (1, 1) mesh: the train step on the
    placed ``DTensor``s themselves, its prefill and two decode steps
    equal the plain ones bit for bit; with 2 microbatches and the int8
    compressor too."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import (init_cache, logical_axes, prefill,
                                    reduced, serve_step)
    from repro_torch.models.convert import numpy_params, params_from_numpy
    from repro_torch.models.model import DenseLM
    from repro_torch.sharding import (batch_shardings, cache_shardings,
                                      distribute, use_mesh)
    from repro_torch.train import (AdamWConfig, TrainConfig, adamw_init,
                                   make_train_step, remesh)
    from repro_torch.train.tree import tree_leaves, tree_map

    sys.path.insert(0, GOLDENS)
    try:
        import shard_compute_replay as replay
    finally:
        sys.path.pop(0)
    cfg = reduced(get_config(arch))
    params = params_from_numpy(numpy_params(cfg, seed=3), cfg, device="cpu")
    opt = adamw_init(params)
    batch = {k: torch.from_numpy(v)
             for k, v in replay.make_batch(cfg, 4, 32, 5).items()}
    flat = lambda p, o: tree_leaves(p) + tree_leaves(o)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(device="cpu")
        place = lambda t: tree_map(distribute, t, batch_shardings(t, mesh))
        p1, o1 = remesh(params, opt, logical_axes(cfg), mesh)
        for tcfg in (TrainConfig(opt=AdamWConfig(lr=1e-2, warmup_steps=1)),
                     TrainConfig(microbatches=2, compress_grads=True)):
            step = make_train_step(cfg, tcfg)
            got = step(p1, o1, place(batch))
            want = step(params, opt, batch)
            for a, b in zip(flat(*got[:2]), flat(*want[:2]), strict=True):
                assert isinstance(a, DTensor) and torch.equal(a.to_local(), b)
            assert got[2]["loss"].to_local().item() == want[2]["loss"].item()
        with torch.no_grad():
            tok = batch["tokens"]
            kw = dict(positions=batch.get("positions"),
                      frames=batch.get("frames"))
            want = prefill(params, tok, cfg, **kw)
            pb = place(batch)
            with use_mesh(mesh):
                got = prefill(p1, pb["tokens"], cfg,
                              positions=pb.get("positions"),
                              frames=pb.get("frames"))
            assert torch.equal(got.to_local(), want)
            cache = init_cache(cfg, 4, 4, "cpu", torch.float32)
            cache_m = tree_map(distribute, init_cache(cfg, 4, 4, "cpu",
                                                      torch.float32),
                               cache_shardings(cache, mesh, cfg))
            if cfg.family == "audio":
                cache["enc_out"] = DenseLM(cfg, params).encode(
                    batch["frames"])
                with use_mesh(mesh):
                    cache_m["enc_out"] = DenseLM(cfg, p1).encode(
                        pb["frames"])
            for t in range(2):
                x = tok[:, t].contiguous()
                a, cache = serve_step(params, cache, x, t, cfg)
                with use_mesh(mesh):
                    b, cache_m = serve_step(p1, cache_m,
                                            place(dict(t=x))["t"], t, cfg)
                assert torch.equal(b.to_local(), a)
            for k, v in cache.items():
                assert torch.equal(cache_m[k].to_local(), v), k
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------
# the CLIs on 4 gloo ranks
# ---------------------------------------------------------------------
def _losses(out: str) -> list:
    return [float(m) for m in re.findall(r"\] step \d+ loss ([0-9.]+)", out)]


def test_train_cli_on_4_gloo_ranks(tmp_path):
    """``launch.train`` under ``torch.distributed.run`` on 4 gloo ranks
    ((2, 2) mesh), reduced TinyLlama, 4 steps of b 4 × 32 with 2
    microbatches: the single process's losses (rtol 1e-5); rank 0 alone
    prints; its sharded checkpoint resumes on 4 ranks."""
    flags = ["--arch", "tinyllama_1_1b", "--reduced", "--batch", "4",
             "--seq", "32", "--device", "cpu", "--log-every", "1",
             "--microbatches", "2"]
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *flags, "--steps", "4"], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           *flags, "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    four = subprocess.run(run + ["--steps", "4"], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert four.returncode == 0, four.stderr[-3000:]
    want, got = _losses(one.stdout), _losses(four.stdout)
    assert len(want) == len(got) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert four.stdout.count("[train] done") == 1
    again = subprocess.run(run + ["--steps", "6"], cwd=ROOT, env=_env(),
                           capture_output=True, text=True, timeout=600)
    assert again.returncode == 0, again.stderr[-3000:]
    assert "[train] resumed from step 4" in again.stdout
    assert len(_losses(again.stdout)) == 2


def test_serve_cli_on_4_gloo_ranks():
    """``launch.serve`` on 4 gloo ranks: the single process's greedy
    tokens (ChatGLM3's 2 KV heads on the (2, 2) mesh)."""
    flags = ["--arch", "chatglm3_6b", "--reduced", "--device", "cpu"]
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *flags], cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=300)
    four = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.serve", *flags],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=600)
    assert one.returncode == 0 and four.returncode == 0, four.stderr[-3000:]
    sample = lambda out: [l for l in out.splitlines() if "sample" in l]
    assert sample(four.stdout) == sample(one.stdout) != []
