"""The PyTorch port's LM path (dense family) against the JAX package.

The same numpy-seeded inputs and weights go through both packages:

* the plain ``flash_attention`` (what the CUDA kernel computes) against
  the JAX oracle ``kernels.ref.flash_attention_ref`` and the Pallas
  kernel in interpret mode, over ``tests/test_kernels.py``'s sweep;
* each layer function, the decoder block, ``forward``, ``prefill`` and a
  ``serve_step`` sequence on ``reduced()`` TinyLlama, Gemma, CodeQwen and
  ChatGLM3 with the weights of ``convert.numpy_params``;
* the ten configs, ``reduced()`` and the dense parameter counts;
* the serve CLI on the CPU, the refusals, and ``chip_smoke.py``'s phase 9
  rehearsed at a small size.

Tolerances (absolute): f32 2e-3 and bf16 3e-2 for attention — the JAX
package's own kernel tolerances (``tests/test_kernels.py``,
docs/KERNELS.md), which the plain version on bf16-rounded inputs does
not meet (``test_f32_tolerance_rejects_bf16_rounding``); 1e-4 for layer
outputs and logits of order 1–10, where only float32 summation order
differs (measured ≤ 1e-5); exact equality where no float arithmetic
differs (configs, counts, rope of position 0).
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import transformer as jtrans
from repro.models.config import reduced as jreduced
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import (DenseLM, cache_specs, forward, init_cache,
                                init_params, layers, prefill, reduced,
                                serve_step, transformer)
from repro_torch.models.convert import numpy_params, params_from_numpy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32, BF16 = 2e-3, 3e-2
LAYER_ATOL = 1e-4
DENSE = ("tinyllama_1_1b", "gemma_2b", "codeqwen1_5_7b", "chatglm3_6b")


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("sq,sk,d,causal", [
    (128, 128, 64, True),
    (256, 256, 64, True),
    (128, 384, 64, True),   # prefill-style: cache longer than queries
    (128, 128, 128, False),
    (256, 128, 64, True),   # sq > sk: only rows that see a key are defined
    (192, 192, 64, True),   # ragged against the Pallas blocks
    (256, 256, 32, True),
    (100, 300, 128, False),  # ragged, non-causal: no padding anywhere
])
def test_flash_plain_matches_jax(sq, sk, d, causal):
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = (_rand(rng, 2, 2, n, d) for n in (sq, sk, sk))
    got = _np(ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal))
    want = np.asarray(jref.flash_attention_ref(q, k, v, causal=causal))
    rows = np.arange(sq) + (sk - sq) >= 0 if causal else np.ones(sq, bool)
    np.testing.assert_allclose(got[:, :, rows], want[:, :, rows], atol=F32)
    assert np.all(got[:, :, ~rows] == 0)  # rows that see no key give 0
    if sq <= sk and (causal or (sq % 128 == 0 and sk % 128 == 0)):
        pallas = jops.flash_attention(q, k, v, causal=causal, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), atol=F32)


def test_flash_plain_bf16_matches_jax():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 2, 128, 64)).to(torch.bfloat16)
               for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    f32 = [np.asarray(t.float()) for t in (q, k, v)]
    want = jref.flash_attention_ref(*f32)
    np.testing.assert_allclose(_np(got.float()), np.asarray(want), atol=BF16)
    pallas = jops.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in f32),
                                  causal=True, interpret=True)
    np.testing.assert_allclose(_np(got.float()),
                               np.asarray(pallas, np.float32), atol=BF16)


@pytest.mark.parametrize("h,kvh,offset", [(8, 2, None), (8, 1, None),
                                           (4, 4, 0), (8, 2, 5)])
def test_flash_plain_gqa_and_offset_match_broadcast(h, kvh, offset):
    """GQA/MQA without repeated heads equals the JAX oracle on repeated
    heads; an explicit offset equals JAX's blockwise attention with that
    ``q_offset`` (top-left alignment)."""
    rng = np.random.default_rng(h * 10 + kvh)
    q = _rand(rng, 2, h, 48, 32)
    k, v = _rand(rng, 2, kvh, 80, 32), _rand(rng, 2, kvh, 80, 32)
    got = _np(ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=True, offset=offset))
    if offset is None:
        rep = [np.repeat(x, h // kvh, axis=1) for x in (k, v)]
        want = jref.flash_attention_ref(q, *rep, causal=True)
    else:
        want = jlayers.blockwise_attention(q, k, v, causal=True, block_q=16,
                                           block_k=16, q_offset=offset)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32)


def test_f32_tolerance_rejects_bf16_rounding():
    """The f32 tolerance is tight enough to see bf16-rounded inputs."""
    rng = np.random.default_rng(7)
    q, k, v = (_rand(rng, 2, 4, 128, 64) * 3 for _ in range(3))
    want = np.asarray(jref.flash_attention_ref(q, k, v, causal=True))
    rounded = [torch.from_numpy(x).to(torch.bfloat16).float() for x in (q, k, v)]
    got = _np(ref.flash_attention_ref(*rounded, causal=True))
    assert np.abs(got - want).max() > F32


def test_blockwise_attention_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, 4, 70, 32), _rand(rng, 2, 2, 70, 32), _rand(rng, 2, 2, 70, 32)
    for causal in (True, False):
        got = layers.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                         causal=causal)
        want = jlayers.blockwise_attention(q, k, v, causal=causal,
                                           block_q=32, block_k=32)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=F32)


# --------------------------------------------------------------- layers
def test_rms_norm_and_mlp_match_jax():
    rng = np.random.default_rng(1)
    x, w = _rand(rng, 2, 5, 64), _rand(rng, 64)
    np.testing.assert_allclose(
        _np(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))),
        np.asarray(jlayers.rms_norm(x, w)), atol=LAYER_ATOL)
    p = dict(w1=_rand(rng, 64, 96) / 8, w2=_rand(rng, 96, 64) / 8,
             w3=_rand(rng, 64, 96) / 8)
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    for kind in ("swiglu", "geglu", "gelu"):
        np.testing.assert_allclose(
            _np(layers.mlp(torch.from_numpy(x), tp, kind)),
            np.asarray(jlayers.mlp(x, p, kind)), atol=LAYER_ATOL)


@pytest.mark.parametrize("rope_type", ["full", "half", "mrope", "none"])
def test_apply_rope_matches_jax(rope_type):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 3, 9, 32)
    pos = rng.integers(0, 500, (2, 9)).astype(np.int32)
    sections = (4, 6, 6) if rope_type == "mrope" else ()
    if rope_type == "mrope":
        pos = np.stack([pos, pos // 2, pos // 3], axis=1)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            rope_type, 10_000.0, sections)
    want = jlayers.apply_rope(x, pos, rope_type, 10_000.0, sections)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)
    zero = layers.apply_rope(torch.from_numpy(x), torch.zeros(
        pos.shape, dtype=torch.int32), rope_type, 10_000.0, sections)
    np.testing.assert_array_equal(_np(zero), x)  # position 0 is identity
    mp = layers.mrope_positions(torch.from_numpy(pos if pos.ndim == 2 else pos[:, 0]))
    np.testing.assert_array_equal(
        mp.numpy(), np.asarray(jlayers.mrope_positions(
            pos if pos.ndim == 2 else pos[:, 0])))


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(4)
    q, kc, vc = _rand(rng, 3, 8, 1, 32), _rand(rng, 3, 2, 20, 32), _rand(rng, 3, 2, 20, 32)
    for length in (1, 7, np.array([3, 20, 11], np.int32)):
        got = layers.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                                      torch.as_tensor(length))
        want = jlayers.decode_attention(q, kc, vc, jnp.asarray(length))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)


# ---------------------------------------------------------------- model
def _models(arch, n_layers=2, seed=0):
    cfg = reduced(get_config(arch), n_layers=n_layers)
    jcfg = jreduced(jget(arch), n_layers=n_layers)
    tree = numpy_params(cfg, seed)
    return (cfg, params_from_numpy(tree, cfg, "cpu"), jcfg,
            jax.tree.map(jnp.asarray, tree))


def test_decoder_block_matches_jax():
    cfg, tp, jcfg, jp = _models("chatglm3_6b")
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 12, cfg.d_model)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    tl = {k: v for k, v in DenseLM(cfg, tp).blocks[1].tree().items()}
    jl = jax.tree.map(lambda a: a[1], jp["blocks"])
    got = transformer.decoder_block(torch.from_numpy(x), tl, cfg,
                                    torch.from_numpy(pos.copy()))
    want = jtrans.decoder_block(x, jl, jcfg, pos)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LAYER_ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_jax(arch):
    cfg, tp, jcfg, jp = _models(arch)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, 20))
    want = np.asarray(JM.forward(jp, jnp.asarray(toks, jnp.int32), jcfg))
    got = _np(forward(tp, torch.from_numpy(toks), cfg))
    np.testing.assert_allclose(got, want, atol=LAYER_ATOL)
    np.testing.assert_allclose(_np(prefill(tp, torch.from_numpy(toks), cfg)),
                               want[:, -1], atol=LAYER_ATOL)
    # the module is the same function
    np.testing.assert_array_equal(_np(DenseLM(cfg, tp)(torch.from_numpy(toks))),
                                  got)
    cache = init_cache(cfg, 2, 24, "cpu")
    jcache = jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                          JM.cache_specs(jcfg, 2, 24, dtype=jnp.float32))
    step = jax.jit(lambda p, c, t, l: JM.serve_step(p, c, t, l, jcfg))
    for i in range(20):
        tl, cache = serve_step(tp, cache, torch.from_numpy(toks[:, i]), i, cfg)
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, i], jnp.int32),
                          jnp.int32(i))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LAYER_ATOL)
        np.testing.assert_allclose(_np(tl), got[:, i], atol=LAYER_ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), np.asarray(jcache[name]),
                                   atol=LAYER_ATOL)


def test_cache_write_past_the_end_is_refused():
    """JAX's dynamic_update_slice would clamp and overwrite the last
    slot; the port raises."""
    cfg, tp, _, _ = _models("tinyllama_1_1b", n_layers=1)
    cache = init_cache(cfg, 1, 4, "cpu")
    with pytest.raises(IndexError, match="outside"):
        serve_step(tp, cache, torch.tensor([1]), 4, cfg)


# -------------------------------------------------------------- configs
def test_registry_matches_jax():
    assert ARCHS == JARCHS


@pytest.mark.parametrize("arch", JARCHS)
def test_config_and_reduced_match_jax(arch):
    for got, want in ((get_config(arch), jget(arch)),
                      (reduced(get_config(arch)), jreduced(jget(arch))),
                      (reduced(get_config(arch), n_layers=1, vocab=64),
                       jreduced(jget(arch), n_layers=1, vocab=64))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.resolved_head_dim == want.resolved_head_dim
        assert (got.is_moe, got.is_mla, got.is_recurrent) == (
            want.is_moe, want.is_mla, want.is_recurrent)
    assert get_config(arch.replace("_", "-")) == get_config(arch)
    cfg = get_config(arch)
    if cfg.family == "dense":
        assert cfg.param_count() == jget(arch).param_count()
        assert cfg.active_param_count() == jget(arch).active_param_count()
        shapes = cache_specs(cfg, 2, 16)
        jshapes = JM.cache_specs(jget(arch), 2, 16)
        assert {k: s for k, (s, _) in shapes.items()} == {
            k: tuple(v.shape) for k, v in jshapes.items()}
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cfg.param_count()


def test_numpy_params_layout_and_distribution():
    cfg = reduced(get_config("gemma_2b"), n_layers=2)
    tree = numpy_params(cfg, 0)
    jshapes = JM.abstract_params(jreduced(jget("gemma_2b"), n_layers=2))
    assert jax.tree.map(lambda a: a.shape, tree) == jax.tree.map(
        lambda a: a.shape, jshapes)
    assert np.all(tree["blocks"]["norm1"] == 1)
    w = tree["blocks"]["ffn"]["w2"]
    assert abs(w.std() * np.sqrt(w.shape[-2]) - 1) < 0.05
    again = numpy_params(cfg, 0)
    np.testing.assert_array_equal(again["embed"], tree["embed"])
    with pytest.raises(ValueError, match="shape"):
        bad = numpy_params(cfg, 0)
        bad["embed"] = bad["embed"][:-1]
        params_from_numpy(bad, cfg, "cpu")


def test_init_params_follows_the_generator():
    cfg = reduced(get_config("tinyllama_1_1b"), n_layers=1)
    a = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    torch.testing.assert_close(a["blocks"]["attn"]["wq"],
                               b["blocks"]["attn"]["wq"], rtol=0, atol=0)
    assert float(a["embed"].std() * cfg.vocab ** 0.5) == pytest.approx(1, abs=0.05)


# ------------------------------------------------------ refusals, CLI
def test_other_families_and_devices_are_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 15"):
        init_params(reduced(get_config("dbrx_132b")), device="cpu")
    q = torch.zeros((1, 2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="CPU tensors"):
        ops.flash_attention(q, q, q)
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card refusal is not testable")
    cfg = reduced(get_config("tinyllama_1_1b"), n_layers=1)
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    from repro_torch.core import csr
    from repro_torch.core.graph import random_bipartite
    with pytest.raises(RuntimeError, match="cuda"):
        csr.pair_wedge_counts(csr.build_wedges(random_bipartite(6, 5, 12, seed=0)))


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "chatglm3_6b", "--reduced", "--batch", "2", "--prompt-len", "5",
         "--gen", "6", "--device", "cpu"],
        env=env, check=True, capture_output=True, text=True,
        timeout=300).stdout.splitlines()
    assert out[0].startswith("[serve] 2 seqs × 11 steps in ")
    sample = eval(out[1].split(":", 1)[1])
    assert len(sample) == 6 and all(0 <= t < 512 for t in sample)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_lm_phase_rehearsed_on_cpu(monkeypatch):
    """``chip_smoke.py``'s phase 9 on the CPU at a small size: the
    recorder's own ``record`` (the JAX package) writes the golden for a
    reduced ChatGLM3, and the phase holds the port to it with the plain
    version of the kernel (so no launches here)."""
    smoke = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    rec = _load("record_torch_lm", os.path.join(
        ROOT, "tests", "goldens", "record_torch_lm.py"))
    cfg = reduced(get_config("chatglm3_6b"), n_layers=2)
    golden = rec.record(jreduced(jget("chatglm3_6b"), n_layers=2), batch=2,
                        seq=24, positions=(0, 11, 23), n_ids=64,
                        log=lambda msg: None)
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, reps: (fn(), 0.0)[1])
    lm = dict(
        smoke.LM, batch=2, seq=40,
        kernel_cases=(("f32", (2, 4, 64, 32), (2, 2, 64, 32), True, None,
                       "float32"),
                      ("bf16", (2, 4, 64, 32), (2, 2, 64, 32), True, None,
                       "bfloat16"),
                      ("offset", (2, 4, 16, 32), (2, 2, 48, 32), True, None,
                       "float32")),
        serve=dict(slots=2, requests=3, prompt=(3, 8), max_new=6, max_seq=32,
                   eos_request=1, eos_index=3),
        cli=["--arch", "chatglm3_6b", "--reduced", "--batch", "2",
             "--prompt-len", "4", "--gen", "4"])
    launches = {}
    row, info = smoke.phase_lm(golden, "cpu", launches, cfg=cfg,
                               golden_cfg=cfg, lm=lm, reps=1)
    assert row["calls_checked"] == 3 and row["bound_by"] == "operations"
    assert launches == {"flash_attention": 0}
    assert info["serve"]["requests"] == 3
    assert max(info["golden"].values()) < LAYER_ATOL
    assert info["positions_compared"] == 11
    # the golden's numbers are the JAX package's: a wrong weight fails
    golden["param_check"]["embed"]["sum"] += 1.0
    with pytest.raises(AssertionError, match="numpy stream"):
        smoke.lm_golden_phase(golden, cfg, "cpu")
