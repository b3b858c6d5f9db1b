"""The PyTorch port's audio family (Whisper-large-v3) against the JAX
package.

The same numpy-seeded inputs and weights (``convert.numpy_params``) go
through both packages on the CPU:

* the parameter tree (keys in order, shapes), the full config's
  parameter counts (1.535 G) and cache shapes;
* ``_sinusoid`` bit for bit, ``_sinusoid_at`` within f32 rounding;
* ``_whisper_encode``, ``_cross_attention`` at Sq 8 and Sq 1, and the
  decoder stack on one reduced model's weights;
* ``forward`` / ``prefill`` with frames, a teacher-forced ``serve_step``
  (its cache's ``enc_out`` the encoder's output) and the caches at the
  end; ``ContinuousBatcher``'s tokens;
* ``train_loss`` and every gradient leaf against ``jax.value_and_grad``;
  the training CLI's batches (frames in ``extra``) and a run of it;
* the serving CLI's frames against the JAX CLI's draw.

Tolerances.  One function: ``LAYER_ATOL`` (1e-4 absolute, f32, only the
summation order differs).  Logits: ``F32`` (2e-3 absolute, as
``tests/test_torch_lm.py``).  Gradients: ``GRAD_RTOL`` (2e-4 relative L2
a leaf, ``tests/test_torch_ssm.py``'s).
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
import repro.models as JM
from repro.configs import get_config as jget
from repro.models import model as jmodel
from repro.models.config import reduced as jreduced
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import batch_extra
from repro_torch.models import (DenseLM, cache_specs, forward, init_cache,
                                prefill, reduced, train_loss)
from repro_torch.models import model as tmodel
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.train.tree import tree_items, tree_leaves, tree_map

torch.set_num_threads(1)

ARCH = "whisper_large_v3"
F32 = 2e-3
LAYER_ATOL = 1e-4
GRAD_RTOL = 2e-4


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _models(seed=0, **over):
    cfg = reduced(get_config(ARCH), **over)
    jcfg = jreduced(jget(ARCH), **over)
    tree = numpy_params(cfg, seed)
    return (cfg, params_from_numpy(tree, cfg, "cpu"), jcfg,
            jax.tree.map(jnp.asarray, tree))


def _frames(cfg, b, seed=3):
    return (np.random.default_rng(seed).normal(
        size=(b, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32)


def _close(got, want, atol=LAYER_ATOL):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ------------------------------------------------------------- the tree
def test_param_specs_and_counts_match_jax():
    """Keys in the JAX package's order (``numpy_params`` draws one stream
    in it), shapes, counts and cache specs, reduced and full."""
    for cfg, jcfg in ((reduced(get_config(ARCH)), jreduced(jget(ARCH))),
                      (get_config(ARCH), jget(ARCH))):
        got = [(p, s.shape) for p, s in tmodel.flat_items(
            tmodel.param_specs(cfg))]
        want = [(p, tuple(s.shape)) for p, s in jmodel.flat_items(
            JM.abstract_params(jcfg))]
        assert got == want
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        specs = cache_specs(cfg, 3, 40, torch.float32)
        jspecs = JM.cache_specs(jcfg, 3, 40, dtype=jnp.float32)
        assert list(specs) == list(jspecs) == ["k", "v", "enc_out"]
        for k, (shape, dt) in specs.items():
            assert shape == tuple(jspecs[k].shape) and dt == torch.float32
    assert round(get_config(ARCH).param_count() / 1e9, 3) == 1.535


def test_sinusoids_match_jax():
    """The table bit for bit (one float64 table, one cast) in f32 and
    bf16; one position's embedding within f32 rounding (computed in
    float32 from the position, not the table's numbers)."""
    for s, d in ((448, 1280), (1500, 1280), (64, 128)):
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)):
            got = tmodel._sinusoid(s, d, tdt)
            want = np.asarray(jmodel._sinusoid(s, d, jdt).astype(jnp.float32))
            np.testing.assert_array_equal(got.float().numpy(), want)
    for pos in (0, 1, 63, 447, 1499):
        got = tmodel._sinusoid_at(pos, 1280, torch.float32)
        want = jmodel._sinusoid_at(jnp.int32(pos), 1280, jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=4 * pos * 2.0 ** -24 + 2.0 ** -24)


# ------------------------------------------------------------ functions
def test_encoder_and_cross_attention_match_jax():
    cfg, tp, jcfg, jp = _models()
    fr = _frames(cfg, 2)
    enc = tmodel._whisper_encode(tp, torch.from_numpy(fr), cfg)
    jenc = jmodel._whisper_encode(jp, jnp.asarray(fr), jcfg)
    _close(enc, jenc)
    rng = np.random.default_rng(5)
    p = {k: v[1] for k, v in tp["dec_blocks"]["cross"].items()}
    jpp = {k: v[1] for k, v in jp["dec_blocks"]["cross"].items()}
    for sq in (8, 1):
        x = rng.standard_normal((2, sq, cfg.d_model)).astype(np.float32)
        _close(tmodel._cross_attention(torch.from_numpy(x), p, cfg, enc),
               jmodel._cross_attention(jnp.asarray(x), jpp, jcfg, jenc))
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    pos = torch.arange(12)[None].expand(2, 12)
    _close(tmodel._whisper_decode_train(tp, torch.from_numpy(x), cfg, pos,
                                        enc),
           jmodel._whisper_decode_train(jp, jnp.asarray(x), jcfg,
                                        jnp.asarray(pos.numpy()), jenc))


# ---------------------------------------------------------------- model
def test_forward_prefill_decode_match_jax():
    cfg, tp, jcfg, jp = _models()
    b, s = 2, 24
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (b, s))
    fr = _frames(cfg, b)
    tt, tf = torch.from_numpy(toks), torch.from_numpy(fr)
    want = np.asarray(JM.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                                 frames=jnp.asarray(fr)))
    np.testing.assert_allclose(_np(forward(tp, tt, cfg, frames=tf)), want,
                               atol=F32)
    np.testing.assert_allclose(_np(prefill(tp, tt, cfg, frames=tf)),
                               want[:, -1], atol=F32)
    model = DenseLM(cfg, tp)
    assert len(model.enc_blocks) == cfg.encoder_layers
    assert len(model.blocks) == cfg.n_layers
    np.testing.assert_allclose(_np(model.prefill(tt, frames=tf)), want[:, -1],
                               atol=F32)
    cache = init_cache(cfg, b, s, "cpu")
    cache["enc_out"] = model.encode(tf).detach()
    jcache = jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                          JM.cache_specs(jcfg, b, s, dtype=jnp.float32))
    jcache["enc_out"] = jmodel._whisper_encode(jp, jnp.asarray(fr), jcfg)
    enc = cache["enc_out"].clone()
    jstep = jax.jit(lambda p, c, t, l: JM.serve_step(p, c, t, l, jcfg))
    for t in range(s):
        lg, cache2 = model.serve_step(cache, tt[:, t], t)
        assert cache2 is cache
        jlg, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t], jnp.int32),
                            jnp.int32(t))
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=F32)
        # tests/test_archs.py::test_whisper_decode_matches_forward's
        np.testing.assert_allclose(_np(lg), want[:, t], atol=2e-2, rtol=1e-2)
    for k, v in cache.items():
        np.testing.assert_allclose(_np(v), np.asarray(jcache[k]), atol=F32)
    assert torch.equal(cache["enc_out"], enc)  # read, never written
    with pytest.raises(ValueError, match="frames"):
        forward(tp, tt, cfg)


@pytest.mark.parametrize("seeded", [False, True])
def test_batcher_tokens_match_jax(seeded):
    """The engines' caches start with ``enc_out`` zeros, as the JAX
    engine's (it has no frames API); ``seeded`` puts both engines' first
    batch on the same encoder output instead (the quiescent reset zeroes
    it, as JAX's ``zeros_like`` over the cache does)."""
    cfg, tp, jcfg, jp = _models(seed=1)
    rng = np.random.default_rng(3)
    reqs = [dict(uid=i, prompt=rng.integers(0, cfg.vocab, 3 + i).tolist(),
                 max_new=5) for i in range(4)]
    eng = ContinuousBatcher(cfg, tp, n_slots=2, max_seq=24, device="cpu")
    jeng = JBatcher(jcfg, jp, n_slots=2, max_seq=24)
    if seeded:
        fr = _frames(cfg, 2, seed=7)
        eng._cache["enc_out"] = DenseLM(cfg, tp).encode(
            torch.from_numpy(fr)).detach()
        jeng._cache["enc_out"] = jmodel._whisper_encode(jp, jnp.asarray(fr),
                                                        jcfg)
    for r in reqs:
        eng.submit(Request(**r))
        jeng.submit(JRequest(**r))
    got = {r.uid: r.output for r in eng.run()}
    want = {r.uid: r.output for r in jeng.run()}
    assert got == want and len(got) == 4
    assert eng.steps == jeng.steps
    assert eng.position == 0
    assert not any(t.any() for t in eng._cache.values())


def test_train_loss_and_grads_match_jax():
    cfg, _, jcfg, _ = _models()
    tree = numpy_params(cfg, 1)
    rng = np.random.default_rng(2)
    batch = dict(tokens=rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
                 labels=rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
                 frames=_frames(cfg, 2))
    jl, jg = jax.value_and_grad(JM.train_loss)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    leaves = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(tree, cfg, "cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = train_loss(leaves, tb, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves)
    for (path, _), got, want in zip(tree_items(leaves), grads, jleaves):
        assert got.shape == want.shape
        assert _rel(_np(got), want) <= GRAD_RTOL, ".".join(path)
    # every encoder weight gets a gradient through cross-attention
    enc = [g for (p, _), g in zip(tree_items(leaves), grads)
           if p[0] in ("enc_blocks", "enc_norm")]
    assert len(enc) == 9 and all(g.abs().max() > 0 for g in enc)


def test_train_extra_is_the_jax_clis():
    """``launch.train``'s batches carry the JAX CLI's frames: the same
    ``synthetic_batches`` stream gives the same arrays in both packages
    (``repro.launch.train`` builds ``extra`` inline; its expression is
    the one below)."""
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import synthetic_batches as jbatches
    from repro_torch.data import DataConfig, synthetic_batches

    cfg = reduced(get_config(ARCH))
    jextra = {"frames": lambda rng: rng.normal(
        size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02}
    got = next(synthetic_batches(DataConfig(2, 16, cfg.vocab, 5),
                                 extra=batch_extra(cfg, 2, 16)))
    want = next(jbatches(JDataConfig(batch=2, seq=16, vocab=cfg.vocab,
                                     seed=5), extra=jextra))
    assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["frames"].dtype == np.float32
    assert batch_extra(reduced(get_config("tinyllama_1_1b")), 2, 16) is None


# ------------------------------------------------------------------ CLI
def test_serve_cli_frames_equal_the_jax_clis(monkeypatch, capsys):
    """Both CLIs on reduced Whisper: the frames each encodes are the
    same array (drawn after the prompts from ``default_rng(--seed)``),
    and the port's run prints the JAX CLI's lines."""
    seen = {}
    real = jmodel._whisper_encode

    def jcapture(params, frames, cfg):
        seen["jax"] = np.asarray(frames)
        return real(params, frames, cfg)

    orig = DenseLM.encode

    def tcapture(self, frames):
        seen["torch"] = frames.numpy().copy()
        return orig(self, frames)

    monkeypatch.setattr(jmodel, "_whisper_encode", jcapture)
    monkeypatch.setattr(DenseLM, "encode", tcapture)
    args = dict(arch=ARCH, reduced=True, batch=2, prompt_len=4, gen=3, seed=2)
    assert jserve.run(argparse.Namespace(**args)) == 0
    assert tserve.run(argparse.Namespace(**args, device="cpu")) == 0
    assert seen["jax"].dtype == seen["torch"].dtype == np.float32
    np.testing.assert_array_equal(seen["torch"], seen["jax"])
    cfg = reduced(get_config(ARCH))
    assert seen["torch"].shape == (2, cfg.encoder_seq, cfg.d_model)
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == ["[serve]"] * 4
    assert out[-1].startswith("[serve] sample:")
    assert len(eval(out[-1].split(":", 1)[1])) == 3


def test_train_cli_on_cpu():
    """``launch.train`` on reduced Whisper: its batches carry frames, the
    loss is finite and falls (the CLI's own lines)."""
    from repro_torch.launch.train import parse_args, train

    out = train(parse_args(["--arch", ARCH, "--reduced", "--steps", "6",
                            "--batch", "2", "--seq", "16", "--log-every",
                            "3", "--device", "cpu"]))
    assert len(out["losses"]) == 6 and np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
