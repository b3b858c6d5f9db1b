"""The PyTorch port's VLM family (Qwen2-VL-72B's decoder under M-RoPE,
the patch frontend a stub) against the JAX package.

The same numpy-seeded inputs and weights (``convert.numpy_params``) go
through both packages on the CPU:

* ``attention`` with three distinct M-RoPE position streams;
* ``forward`` and ``prefill`` with positions that hold an image block
  (``chip_smoke.mrope_image_positions``: text, a patch grid whose t
  stays fixed while h and w walk it, text), and on text-only positions;
* a teacher-forced ``serve_step`` on text-only positions (a decode step
  puts its token at one position on all three streams, in the reference
  too) and the caches at the end; ``ContinuousBatcher``'s tokens;
* ``train_loss`` and every gradient leaf against ``jax.value_and_grad``,
  on the training CLI's batches (M-RoPE positions in ``extra``) and on
  image-block positions, and a run of the CLI;
* the full config's parameter count (72.71 G) and cache shapes;
* ``chip_smoke.py``'s phase 16 (Whisper and Qwen2-VL) rehearsed at a
  small size.

Tolerances.  One function: ``LAYER_ATOL`` (1e-4 absolute, f32).
Logits: ``F32`` (2e-3 absolute).  Gradients: ``GRAD_RTOL`` (2e-4
relative L2 a leaf, ``tests/test_torch_ssm.py``'s).
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro.configs import get_config as jget
from repro.models import transformer as jtrans
from repro.models.config import reduced as jreduced
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, synthetic_batches
from repro_torch.launch.train import batch_extra
from repro_torch.models import (DenseLM, cache_specs, forward, init_cache,
                                prefill, reduced, train_loss, transformer)
from repro_torch.models.convert import numpy_params, params_from_numpy
from repro_torch.serve import ContinuousBatcher, Request
from repro_torch.train.tree import tree_items, tree_leaves, tree_map

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2_vl_72b"
F32 = 2e-3
LAYER_ATOL = 1e-4
GRAD_RTOL = 2e-4


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))


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


def test_image_positions_follow_qwen2_vl():
    pos = smoke.mrope_image_positions(2, 24, 4, (3, 4))
    assert pos.shape == (2, 3, 24) and pos.dtype == np.int32
    assert (pos[0] == pos[1]).all()
    np.testing.assert_array_equal(pos[0, :, :4], np.tile(np.arange(4), (3, 1)))
    np.testing.assert_array_equal(pos[0, 0, 4:16], [4] * 12)
    np.testing.assert_array_equal(pos[0, 1, 4:16], np.repeat(4 + np.arange(3), 4))
    np.testing.assert_array_equal(pos[0, 2, 4:16], np.tile(4 + np.arange(4), 3))
    # the text after resumes at start + max(h, w) on every stream
    np.testing.assert_array_equal(pos[0, :, 16:],
                                  np.tile(8 + np.arange(8), (3, 1)))
    with pytest.raises(ValueError, match="fit"):
        smoke.mrope_image_positions(1, 10, 4, (3, 3))


def test_mrope_attention_with_three_streams_matches_jax():
    """Distinct t/h/w streams through ``attention``: each section of the
    head dim rotates by its own stream, against the text-only result
    too (they must differ)."""
    cfg, tp, jcfg, jp = _models()
    p = {k: v[0] for k, v in tp["blocks"]["attn"].items()}
    jpp = {k: v[0] for k, v in jp["blocks"]["attn"].items()}
    x = np.random.default_rng(3).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    pos = smoke.mrope_image_positions(2, 32, 6, (4, 5))
    got = transformer.attention(torch.from_numpy(x), p, cfg,
                                torch.from_numpy(pos))
    want = jtrans.attention(jnp.asarray(x), jpp, jcfg, jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)
    text = transformer.attention(torch.from_numpy(x), p, cfg, torch.from_numpy(
        np.broadcast_to(np.arange(32, dtype=np.int32), (2, 3, 32)).copy()))
    assert float((got - text).abs().max()) > 1e-2


def test_forward_prefill_decode_match_jax():
    cfg, tp, jcfg, jp = _models()
    b, s = 2, 40
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (b, s))
    tt, jt = torch.from_numpy(toks), jnp.asarray(toks, jnp.int32)
    pos = smoke.mrope_image_positions(b, s, 8, (4, 6))
    want_img = np.asarray(JM.forward(jp, jt, jcfg, positions=jnp.asarray(pos)))
    got_img = forward(tp, tt, cfg, positions=torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got_img), want_img, atol=F32)
    np.testing.assert_allclose(
        _np(prefill(tp, tt, cfg, positions=torch.from_numpy(pos))),
        want_img[:, -1], atol=F32)
    want = np.asarray(JM.forward(jp, jt, jcfg))
    np.testing.assert_allclose(_np(forward(tp, tt, cfg)), want, atol=F32)
    np.testing.assert_allclose(_np(prefill(tp, tt, cfg)), want[:, -1],
                               atol=F32)
    # text-only positions given as three equal streams are the default
    text = np.broadcast_to(np.arange(s, dtype=np.int32), (b, 3, s)).copy()
    np.testing.assert_array_equal(
        _np(forward(tp, tt, cfg, positions=torch.from_numpy(text))),
        _np(forward(tp, tt, cfg)))
    assert np.abs(want_img[:, 8:] - want[:, 8:]).max() > 1e-2
    model = DenseLM(cfg, tp)
    cache = init_cache(cfg, b, s, "cpu")
    jcache = jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                          JM.cache_specs(jcfg, b, s, dtype=jnp.float32))
    jstep = jax.jit(lambda p, c, t, l: JM.serve_step(p, c, t, l, jcfg))
    for t in range(s):
        lg, _ = model.serve_step(cache, tt[:, t], t)
        jlg, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t], jnp.int32),
                            jnp.int32(t))
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), atol=F32)
        np.testing.assert_allclose(_np(lg), want[:, t], atol=F32)
    for k, v in cache.items():
        np.testing.assert_allclose(_np(v), np.asarray(jcache[k]), atol=F32)


def test_batcher_tokens_match_jax():
    cfg, tp, jcfg, jp = _models(seed=1)
    rng = np.random.default_rng(3)
    reqs = [dict(uid=i, prompt=rng.integers(0, cfg.vocab, 3 + i).tolist(),
                 max_new=5, eos=(None if i else 7)) for i in range(4)]
    eng = ContinuousBatcher(cfg, tp, n_slots=2, max_seq=24, device="cpu")
    jeng = JBatcher(jcfg, jp, n_slots=2, max_seq=24)
    for r in reqs:
        eng.submit(Request(**r))
        jeng.submit(JRequest(**r))
    got = {r.uid: r.output for r in eng.run()}
    want = {r.uid: r.output for r in jeng.run()}
    assert got == want and len(got) == 4
    assert eng.steps == jeng.steps


@pytest.mark.parametrize("image", [False, True])
def test_train_loss_and_grads_match_jax(image):
    """On a batch of the training CLI (its ``extra`` positions: three
    equal streams, as the JAX CLI's) and on image-block positions."""
    cfg, _, jcfg, _ = _models()
    tree = numpy_params(cfg, 1)
    batch = next(synthetic_batches(DataConfig(2, 16, cfg.vocab, 4),
                                   extra=batch_extra(cfg, 2, 16)))
    assert batch["positions"].shape == (2, 3, 16)
    if image:
        batch["positions"] = smoke.mrope_image_positions(2, 16, 2, (3, 3))
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


def test_param_count_and_cache_specs_match_jax():
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    assert cfg.param_count() == jcfg.param_count()
    assert round(cfg.param_count() / 1e9, 2) == 72.71
    assert round(dataclasses.replace(cfg, n_layers=8).param_count() / 1e9,
                 2) == 9.51
    got = cache_specs(cfg, 2, 16)
    want = JM.cache_specs(jcfg, 2, 16)
    assert {k: s for k, (s, _) in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


# ------------------------------------------------------- the smoke phase
def test_chip_smoke_audio_vlm_phase_rehearsed_on_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 16 on the CPU at a small size: the
    recorder's own ``record`` (the JAX package) writes the goldens for
    reduced Whisper and Qwen2-VL, and the phase holds the port to them
    with every other gate live (the serving CLIs among its steps).  A
    decode step whose sinusoid sits one position late must fail."""
    from repro_torch.models import model as tmodel

    rec = _load("record_torch_audio_vlm", os.path.join(
        ROOT, "tests", "goldens", "record_torch_audio_vlm.py"))
    small = {"whisper_large_v3": 2, "qwen2_vl_72b": 1}
    golden = {arch: rec.record(jreduced(jget(arch), n_layers=n),
                               rec.MODELS[i][2], batch=2, seq=32,
                               positions=(0, 9, 31), n_ids=64,
                               image=dict(start=4, grid=(4, 4)),
                               log=lambda msg: None)
              for i, (arch, n) in enumerate(small.items())}
    gcfgs = {arch: reduced(get_config(arch), n_layers=n)
             for arch, n in small.items()}
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, reps: (fn(), 0.0)[1])
    av = smoke.AUDIO_VLM
    spec = dict(
        av,
        kernel_cases=(
            ("encoder bf16", (2, 4, 64, 32), (2, 4, 64, 32), False, None,
             "bfloat16"),
            ("cross decode f32", (2, 4, 1, 32), (2, 4, 64, 32), False, None,
             "float32"),
            ("prefill f32", (2, 4, 48, 32), (2, 2, 48, 32), True, None,
             "float32")),
        reps=1,
        whisper=dict(av["whisper"], cfg=reduced(get_config(
            "whisper_large_v3")), batch=2, seq=16, check_batch=2,
            check_seq=8, serve=dict(slots=2, requests=3, prompt=(3, 6),
                                    max_new=4, max_seq=16, eos_request=1,
                                    eos_index=2)),
        qwen=dict(av["qwen"], cfg=reduced(get_config(ARCH)), n_layers=2,
                  batch=2, seq=32, image=dict(start=4, grid=(4, 4)),
                  check_batch=2, check_seq=8),
        cli=tuple([*args[:2], "--reduced", "--batch", "2", "--prompt-len",
                   "4", "--gen", "4"] for args in av["cli"]),
        train=dict(av["train"], models=(
            dict(av["train"]["models"][0], cfg=reduced(get_config(
                "whisper_large_v3")), batch=2, seq=16),
            dict(av["train"]["models"][1], cfg=reduced(get_config(ARCH)),
                 batch=2, seq=32, image=dict(start=4, grid=(4, 4)))),
            cli_flags=["--steps", "8", "--batch", "2", "--seq", "16",
                       "--log-every", "1"]))
    launches = {}
    row, info = smoke.phase_audio_vlm(golden, "cpu", launches, spec=spec,
                                      golden_cfgs=gcfgs)
    assert launches == {"flash_attention": 0}
    assert row["launches"] == {"whisper": 0, "qwen": 0, "training": 0}
    train = info["train"]
    assert set(train) == {"whisper-large-v3", "qwen2-vl-72b", "cli"}
    for name in ("whisper-large-v3", "qwen2-vl-72b"):
        assert train[name]["plain_worst_rel_l2"] <= smoke.TRAIN_GRAD_RTOL
        assert train[name]["remat_worst_rel_l2"] <= smoke.MOE_REMAT_RTOL
    assert set(train["cli"]) == {"whisper_large_v3", ARCH}
    assert [c["library_ms"] for c in row["cases"]] == [0.0] * 3
    assert info["whisper"]["decode"]["max_abs_err"] < 2e-2
    assert info["qwen"]["decode"]["max_abs_err"] < smoke.LOGIT_ATOL
    assert info["whisper"]["serve"]["requests"] == 3
    for errs in info["golden"].values():
        assert max(v for k, v in errs.items()
                   if k not in ("bf16", "upload_s")) < smoke.LOGIT_ATOL
        assert errs["bf16"]["rel"] <= errs["bf16"]["limit"]
    assert set(info["golden"]["qwen2_vl_72b"]) >= {"image_forward", "decode"}
    assert [lines[-1].startswith("[serve] sample:")
            for lines in info["cli"]] == [True, True]
    # the decode step's position one late: decode no longer matches
    real = tmodel._sinusoid_at
    monkeypatch.setattr(tmodel, "_sinusoid_at",
                        lambda pos, *a, **k: real(pos + 1, *a, **k))
    with pytest.raises(AssertionError):
        smoke.whisper_f32(spec["whisper"], "cpu", {})


def test_train_cli_on_cpu():
    """``launch.train`` on reduced Qwen2-VL with the JAX CLI's M-RoPE
    positions: the loss is finite and falls."""
    from repro_torch.launch.train import parse_args, train

    out = train(parse_args(["--arch", ARCH, "--reduced", "--steps", "6",
                            "--batch", "2", "--seq", "16", "--log-every",
                            "3", "--device", "cpu"]))
    assert len(out["losses"]) == 6 and np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
