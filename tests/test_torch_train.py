"""The port's training path (dense family) against the JAX package.

The same numpy-seeded weights (``convert.numpy_params``) and batches go
through both packages on the CPU, where the port's ``flash_attention``
forward is its plain version and its backward the port's own
(``kernels.flash_attention.attention_backward``):

* the attention gradients against ``jax.grad`` of the JAX package's
  ``blockwise_attention`` (causal and not, GQA/MQA, an offset, D 32 and
  64, more query rows than one backward block);
* ``train_loss`` and every leaf's gradient against
  ``jax.value_and_grad(train_loss)``, ``loss_chunk`` 0 and 8, remat
  ``full`` / ``dots`` / ``none``;
* ``adamw_update`` from the same gradients, and three whole train steps;
* ``tests/test_train.py``'s behaviours on the port (loss falls,
  microbatching, compression, checkpoints, crash and resume through
  ``python -m repro_torch.launch.train --device cpu``, the straggler
  detector), checkpoints across the two packages both ways, and
  ``tests/test_system.py``'s graph-to-LM run.

Tolerances: float32 summation order is all that differs between the
packages.  Attention and loss gradients are held to 1e-5 relative L2
per tensor (measured ≤ 1.6e-6); the loss to 1e-6 relative (measured
equal); an AdamW update from the same gradients to 1e-6 relative and
1e-7 absolute (one f32 rounding of each term); three whole steps to
1e-5 relative on the metrics and on the weights (1e-6 absolute), save
at most 0.1 % of a tensor's weights, which must stay within the steps'
summed learning rates (Adam normalises each gradient component, so a
component near 0 whose rounding differs moves its weight by up to a
step; measured: 2 weights of 0.6 M, the worst 9.4e-5 of 3e-4).
Checkpoint arrays and hashes are exact.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro.configs import get_config as jget
from repro.data import curriculum_sequences as jcurriculum
from repro.models import layers as jlayers
from repro.models.config import reduced as jreduced
from repro.train import TrainConfig as JTrainConfig
from repro.train import checkpoint as jckpt
from repro.train import make_train_step as jmake_train_step
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_init as jadamw_init
from repro.train.optimizer import adamw_update as jadamw_update
from repro_torch.configs import get_config
from repro_torch.core.graph import powerlaw_bipartite
from repro_torch.data import curriculum_sequences, sequence_batches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import reduced, train_loss
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.train import (AdamWConfig, OptState, StragglerDetector,
                               TrainConfig, adamw_init, adamw_update,
                               latest_step, make_train_step,
                               restore_checkpoint, save_checkpoint)
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.tree import tree_leaves, tree_map

# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_RTOL = 1e-5       # relative L2 of a gradient tensor
STRAY_SHARE = 1e-3     # weights of a tensor off 1e-5 after three steps
ARCH = "tinyllama_1_1b"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t):
    return t.detach().cpu().numpy()


def _cfgs(**kw):
    return jreduced(jget(ARCH), **kw), reduced(get_config(ARCH), **kw)


def _batch(cfg, b=2, s=32, seed=2):
    rng = np.random.default_rng(seed)
    return dict(tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
                labels=rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _state(cfg, seed=1):
    """(numpy tree, port params, port opt state)."""
    tree = numpy_params(cfg, seed=seed)
    params = params_from_numpy(tree, cfg, device="cpu")
    return tree, params, adamw_init(params)


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("B,H,KVH,sq,sk,D,causal,offset", [
    (2, 4, 2, 128, 128, 32, True, 0),
    (2, 4, 4, 128, 128, 64, False, 0),
    (1, 8, 2, 64, 192, 64, True, 128),     # queries at the cache's end
    (1, 4, 1, 96, 160, 32, True, 16),      # MQA, an offset below sk - sq
    (1, 2, 1, 600, 600, 32, True, 0),      # two backward blocks
])
def test_attention_grads_match_jax(B, H, KVH, sq, sk, D, causal, offset):
    rng = np.random.default_rng(sq + sk + D)
    q = rng.standard_normal((B, H, sq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, KVH, sk, D)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal((B, H, sq, D)).astype(np.float32)

    def jloss(q, k, v):
        out = jlayers.blockwise_attention(q, k, v, causal=causal,
                                          q_offset=offset)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, offset=offset)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, ref_ in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert _rel(_np(got), ref_) <= GRAD_RTOL, name


@pytest.mark.parametrize("offset", [-8, 0, 40])
def test_attention_backward_matches_plain_autograd(offset):
    """The Function's backward against torch autograd through the plain
    version, rows that see no key (offset < 0) included: there the
    output is 0 and so is every gradient through it."""
    g = torch.Generator().manual_seed(offset + 100)
    q = torch.randn((1, 4, 80, 32), generator=g)
    k, v = (torch.randn((1, 2, 96, 32), generator=g) for _ in range(2))
    w = torch.randn((1, 4, 80, 32), generator=g)
    grads = []
    for fn in (lambda *a: ops.flash_attention(*a, causal=True, offset=offset),
               lambda *a: ref.flash_attention_ref(*a, causal=True,
                                                  offset=offset)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert _rel(_np(a), _np(b)) <= GRAD_RTOL


# ---------------------------------------------------------- train_loss
@pytest.mark.parametrize("loss_chunk", [0, 8])
@pytest.mark.parametrize("remat_policy", ["full", "dots", "none"])
def test_train_loss_and_grads_match_jax(loss_chunk, remat_policy):
    jcfg, cfg = _cfgs(n_layers=2, loss_chunk=loss_chunk,
                      remat_policy=remat_policy)
    tree, params, _ = _state(cfg)
    batch = _batch(cfg)
    jl, jg = jax.value_and_grad(JM.train_loss)(
        jax.tree.map(jnp.asarray, tree), _jb(batch), jcfg)
    leaves = tree_map(lambda t: t.requires_grad_(), params)
    calls = []
    real = fa._forward
    fa._forward = lambda *a: calls.append(1) or real(*a)
    try:
        loss = train_loss(leaves, _tb(batch), cfg)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
    finally:
        fa._forward = real
    # each layer's attention runs once, and again in its recompute
    assert len(calls) == cfg.n_layers * (1 if remat_policy == "none" else 2)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for got, want in zip(grads, jleaves):
        assert got.shape == want.shape
        assert _rel(_np(got), want) <= GRAD_RTOL


# ------------------------------------------------------------ optimizer
def _grads_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
        tree)


def test_adamw_update_matches_jax():
    _, cfg = _cfgs(n_layers=2)
    tree, params, opt = _state(cfg)
    ocfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    jocfg = JAdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = jadamw_init(jparams)
    jupdate = jax.jit(jadamw_update, static_argnums=3)
    for i in range(3):
        g = _grads_like(tree, 10 + i)
        if i == 2:  # a clipped step: global norm far above grad_clip
            g = jax.tree.map(lambda a: a * 30, g)
        jparams, jopt, jm = jupdate(jparams, jax.tree.map(
            jnp.asarray, g), jopt, jocfg)
        params, opt, m = adamw_update(params, params_from_numpy(
            g, cfg, device="cpu"), opt, ocfg)
        assert int(opt.step) == int(jopt.step) == i + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
        for got, want in zip(
                tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(
                    opt.nu), jax.tree.leaves((jparams, jopt.mu, jopt.nu))):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


def test_three_train_steps_match_jax():
    jcfg, cfg = _cfgs(n_layers=2)
    tree, params, opt = _state(cfg)
    ocfg = dict(lr=5e-3, total_steps=50)
    jstep = jax.jit(jmake_train_step(
        jcfg, JTrainConfig(opt=JAdamWConfig(**ocfg))))
    step = make_train_step(cfg, TrainConfig(opt=AdamWConfig(**ocfg)))
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = jadamw_init(jparams)
    moved = 0.0
    for i in range(3):
        batch = _batch(cfg, seed=20 + i)
        jparams, jopt, jm = jstep(jparams, jopt, _jb(batch))
        params, opt, m = step(params, opt, _tb(batch))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
        moved += float(m["lr"])
    p0 = jax.tree.leaves(tree)
    for got, want, start in zip(tree_leaves(params), jax.tree.leaves(jparams),
                                p0):
        assert not got.requires_grad
        got, want = _np(got), np.asarray(want)
        # Adam divides each gradient component by its own scale, so a
        # component near 0 whose f32 rounding differs moves its weight by
        # up to a step: a few weights may stray from 1e-5, none by more
        # than the steps' summed learning rates
        off = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
        assert off.mean() <= STRAY_SHARE, off.sum()
        assert np.abs(got - want).max() <= moved


# ------------------------------------- tests/test_train.py, on the port
def _setup(**kw):
    _, cfg = _cfgs(**kw)
    tree, params, opt = _state(cfg, seed=0)
    rng0, rng1 = np.random.default_rng(0), np.random.default_rng(1)
    batch = dict(
        tokens=torch.from_numpy(rng0.integers(0, cfg.vocab, (4, 32))),
        labels=torch.from_numpy(rng1.integers(0, cfg.vocab, (4, 32))))
    return cfg, params, opt, batch


def test_train_step_reduces_loss():
    cfg, params, opt, batch = _setup()
    step = make_train_step(
        cfg, TrainConfig(opt=AdamWConfig(lr=5e-3, total_steps=50)))
    losses = []
    for _ in range(12):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
    assert int(opt.step) == 12


def test_microbatching_matches_full_batch():
    cfg, params, opt, batch = _setup()
    p1, _, m1 = make_train_step(cfg, TrainConfig(microbatches=1))(
        params, opt, batch)
    p2, _, m2 = make_train_step(cfg, TrainConfig(microbatches=2))(
        params, opt, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-4)


def test_grad_compression_still_trains():
    cfg, params, opt, batch = _setup()
    step = make_train_step(cfg, TrainConfig(
        compress_grads=True, opt=AdamWConfig(lr=5e-3, total_steps=50)))
    losses = []
    for _ in range(10):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def test_compress_int8_matches_jax():
    from repro.train.train_step import _compress_int8 as jcompress
    from repro_torch.train.train_step import _compress_int8

    g = (np.random.default_rng(3).standard_normal((64, 33)) * 0.01).astype(
        np.float32)
    g[0, :4] = (0.5, -0.5, 1.5, 2.5)      # ties round to even
    np.testing.assert_array_equal(_np(_compress_int8(torch.from_numpy(g))),
                                  np.asarray(jcompress(jnp.asarray(g))))


def test_checkpoint_roundtrip(tmp_path):
    cfg, params, opt, batch = _setup()
    params, opt, _ = make_train_step(cfg)(params, opt, batch)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, 7, params, opt, extra=dict(arch=cfg.name))
    assert latest_step(path) == 7
    p2, o2, man = restore_checkpoint(path, 7, params, opt)
    assert man["extra"]["arch"] == cfg.name
    for a, b in zip(tree_leaves(params) + tree_leaves(opt.mu),
                    tree_leaves(p2) + tree_leaves(o2.mu)):
        assert torch.equal(a, b)
    assert int(o2.step) == int(opt.step) == 1
    assert o2.step.dtype == torch.int32
    with pytest.raises(ValueError, match="tree structure"):
        restore_checkpoint(path, 7, {"embed": params["embed"]}, opt)


def test_incomplete_checkpoint_invisible(tmp_path):
    cfg, params, opt, _ = _setup()
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, 3, params, opt)
    # simulate a crash mid-save at step 9: directory without manifest
    os.makedirs(os.path.join(path, "step_00000009"))
    assert latest_step(path) == 3


def test_checkpoints_cross_packages(tmp_path):
    """A checkpoint written by the JAX package restores in the port and
    one written by the port restores in the JAX package: equal hashes,
    keys and arrays, the moments after one step included."""
    jcfg, cfg = _cfgs(n_layers=2)
    tree, params, opt = _state(cfg)
    batch = _batch(cfg)
    params, opt, _ = make_train_step(cfg)(params, opt, _tb(batch))
    jparams = jax.tree.map(jnp.asarray, tree)
    jparams, jopt, _ = jax.jit(jmake_train_step(jcfg))(
        jparams, jadamw_init(jparams), _jb(batch))
    assert tckpt._treedef_hash(params) == jckpt._treedef_hash(jparams)
    assert tckpt._treedef_hash(opt) == jckpt._treedef_hash(jopt)
    assert list(tckpt._flat(opt)) == list(jckpt._flat(jopt))
    both = lambda p, o: tree_leaves(p) + tree_leaves(o.mu) + tree_leaves(
        o.nu) + [o.step]

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save_checkpoint(jdir, 4, jparams, jopt, extra=dict(by="jax"))
    p, o, man = restore_checkpoint(jdir, 4, params, opt)
    assert man["extra"] == {"by": "jax"}
    for got, want in zip(both(p, o), jax.tree.leaves((jparams, jopt))):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        assert _np(got).dtype == np.asarray(want).dtype

    save_checkpoint(tdir, 5, params, opt, extra=dict(by="torch"))
    jp, jo, jman = jckpt.restore_checkpoint(tdir, 5, jparams, jopt)
    assert jman["extra"] == {"by": "torch"} and jman["n_processes"] == 1
    for got, want in zip(jax.tree.leaves((jp, jo)), both(params, opt)):
        np.testing.assert_array_equal(np.asarray(got), _np(want))
    with open(os.path.join(tdir, "step_00000005", "MANIFEST.json")) as f:
        tman = f.read()
    with open(os.path.join(jdir, "step_00000004", "MANIFEST.json")) as f:
        assert f.read() == tman.replace('"step": 5', '"step": 4').replace(
            '"torch"', '"jax"')


def test_crash_and_resume(tmp_path):
    """Kill training mid-run; the resumed run continues from the
    checkpoint and finishes (``python -m repro_torch.launch.train``)."""
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    args = [sys.executable, "-m", "repro_torch.launch.train",
            "--arch", ARCH, "--reduced", "--device", "cpu",
            "--steps", "30", "--batch", "4", "--seq", "32",
            "--ckpt-dir", ckpt, "--ckpt-every", "10", "--log-every", "5"]
    out1 = subprocess.run(args + ["--crash-at", "15"], env=env,
                          capture_output=True, text=True, timeout=600)
    assert out1.returncode == 42, out1.stderr[-1500:]
    assert "[train] injected crash" in out1.stdout
    assert latest_step(ckpt) == 10
    out2 = subprocess.run(args, env=env, capture_output=True, text=True,
                          timeout=600)
    assert out2.returncode == 0, out2.stderr[-1500:]
    assert "resumed from step 10" in out2.stdout
    assert "[train] done: loss" in out2.stdout and "(20 steps" in out2.stdout
    assert latest_step(ckpt) == 30


def test_straggler_detector():
    det = StragglerDetector(alpha=0.5, threshold_sigma=1.0)
    import time
    for _ in range(5):
        det.start()
        time.sleep(0.01)
        det.stop()
    det.start()
    time.sleep(0.08)
    assert det.stop() is True


# --------------------------------------- tests/test_system.py, on the port
def test_graph_to_lm_training():
    """The paper's application on the port: the decomposition-ordered
    curriculum (equal to the JAX package's) trains a reduced TinyLlama
    whose vocabulary is the node set, and the loss falls."""
    g = powerlaw_bipartite(80, 40, 400, seed=5)
    seqs = curriculum_sequences(g, n_levels=3, P=4, max_len=16, device="cpu")
    assert len(seqs) > 10
    for a, b in zip(seqs, jcurriculum(g, n_levels=3, P=4, max_len=16)):
        np.testing.assert_array_equal(a, b)
    _, cfg = _cfgs(vocab=g.n_u + g.n_v, n_layers=2, max_seq=16)
    params = params_from_numpy(numpy_params(cfg, seed=0), cfg, device="cpu")
    opt = adamw_init(params)
    step = make_train_step(
        cfg, TrainConfig(opt=AdamWConfig(lr=1e-2, total_steps=60)))
    losses = []
    for _ in range(2):
        for batch in sequence_batches(seqs, batch=8, seq_len=15):
            params, opt, m = step(params, opt, _tb(batch))
            losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], (losses[0], losses[-1])


def test_opt_state_is_a_namedtuple_of_trees():
    _, cfg = _cfgs(n_layers=1)
    _, params, opt = _state(cfg)
    assert isinstance(opt, OptState) and opt.step.dtype == torch.int32
    assert [t.shape for t in tree_leaves(opt.mu)] == [
        t.shape for t in tree_leaves(params)]
